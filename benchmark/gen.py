"""The one generator of inputs: feature stores, pairs and weights, made on
the device from a seed in a few large calls.

Data follows the planted-cluster design of the program's synthetic set
(``data/synthetic.py``, copied here so that the program cannot move the
yardstick): every entity has a latent cluster; numeric features are a
cluster centroid plus noise; each text block is a cluster's vector plus
noise; a categorical id is a per-feature map of the cluster, with 10% of ids
redrawn uniformly ("clustered"), or uniform over the vocabulary ("uniform",
BASELINE config 3); a pair joins a notice with a company of its cluster.
Sizes and the id law come from the traffic file, widths from the config.

Weights are keyed as the program's ``state_dict``: dense kernels drawn
N(0, 1/fan_in), biases N(0, 0.01^2), BatchNorm scale 1 + N(0, 0.1^2), bias,
running mean N(0, 0.1^2), running variance U(0.5, 1.5), tables N(0, 1/D).
Biases and statistics are random, not flax's zeros and ones, so that a
wrong map of any of them shows in the comparison.
"""

from __future__ import annotations

import torch

CENTROID_DIM = 8


def _ids(gen, cluster, vocab: list[int], n_clusters: int, law: str, device) -> torch.Tensor:
    vmax = torch.tensor(vocab, dtype=torch.float64, device=device)
    uniform = (torch.rand((cluster.shape[0], len(vocab)), generator=gen, device=device, dtype=torch.float64)
               * vmax).long()
    if law == "uniform":
        return uniform.to(torch.int32)
    if law != "clustered":
        raise ValueError(f"unknown id law {law!r}")
    table = (torch.rand((n_clusters, len(vocab)), generator=gen, device=device, dtype=torch.float64) * vmax).long()
    flip = torch.rand((cluster.shape[0], len(vocab)), generator=gen, device=device) < 0.1
    return torch.where(flip, uniform, table[cluster]).to(torch.int32)


def side_store(gen, side: dict, n_rows: int, traffic: dict, centroids, text_centroids, device):
    """(dense f32 [n, width], cat_ids int32 [n, K], cluster [n]) of one side."""
    n_clusters = traffic["n_clusters"]
    noise = traffic.get("noise", 0.3)
    cluster = torch.randint(0, n_clusters, (n_rows,), generator=gen, device=device)
    parts = []
    if side["num_numeric"]:
        reps = -(-side["num_numeric"] // CENTROID_DIM)
        base = centroids.repeat(1, reps)[:, : side["num_numeric"]]
        parts.append(base[cluster] + noise * torch.randn((n_rows, side["num_numeric"]), generator=gen, device=device))
    for tc in text_centroids:
        parts.append(tc[cluster] + noise * torch.randn((n_rows, tc.shape[1]), generator=gen, device=device))
    dense = torch.cat(parts, dim=1) if parts else torch.zeros((n_rows, 0), device=device)
    cat = _ids(gen, cluster, side["vocab_sizes"], n_clusters, traffic.get("ids", "clustered"), device)
    return dense, cat, cluster


def make_data(schema: dict, traffic: dict, seed: int, device) -> dict:
    """``{side: (dense, cat_ids)}`` for both sides and, where the
    traffic has ``n_pairs``, ``pairs`` int64 [P, 2] of (notice row, company
    row) within one cluster. One seed gives the same tensors on one device."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_clusters = traffic["n_clusters"]
    centroids = torch.randn((n_clusters, CENTROID_DIM), generator=gen, device=device)
    out, clusters = {}, {}
    for name in ("notice", "company"):
        side = schema[name]
        text_centroids = [torch.randn((n_clusters, d), generator=gen, device=device) for d in side["text"].values()]
        n_rows = traffic["n_notices" if name == "notice" else "n_companies"]
        dense, cat, clusters[name] = side_store(gen, side, n_rows, traffic, centroids, text_centroids, device)
        out[name] = (dense, cat)
    if traffic.get("n_pairs"):
        out["pairs"] = _pairs(gen, clusters["notice"], clusters["company"], traffic["n_pairs"], n_clusters, device)
    return out


def _pairs(gen, notice_cluster, company_cluster, n_pairs: int, n_clusters: int, device) -> torch.Tensor:
    order = torch.argsort(company_cluster, stable=True)
    counts = torch.bincount(company_cluster, minlength=n_clusters)
    if bool((counts == 0).any()):
        raise ValueError("a cluster has no company: raise n_companies or lower n_clusters")
    starts = torch.cumsum(counts, 0) - counts
    n_idx = torch.randint(0, notice_cluster.shape[0], (n_pairs,), generator=gen, device=device)
    cl = notice_cluster[n_idx]
    pos = (torch.rand((n_pairs,), generator=gen, device=device, dtype=torch.float64) * counts[cl]).long()
    return torch.stack([n_idx, order[starts[cl] + pos]], dim=1)


def make_weights(shapes: dict[str, tuple[int, ...]], seed: int, device) -> dict[str, torch.Tensor]:
    """Weights for every ``state_dict`` key of ``shapes``: one normal draw
    over all leaves and one uniform draw over the running variances, each
    leaf a scaled view of them."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    variances = [k for k in shapes if k.endswith("running_var")]
    normal = torch.randn((sum(_numel(s) for k, s in shapes.items() if k not in variances),), generator=gen,
                         device=device)
    uniform = torch.rand((sum(_numel(shapes[k]) for k in variances),), generator=gen, device=device)
    out, at, at_u = {}, 0, 0
    for key, shape in shapes.items():
        n = _numel(shape)
        leaf = key.rsplit(".", 1)[-1]
        if key in variances:
            out[key] = uniform[at_u : at_u + n].view(shape).add_(0.5)
            at_u += n
            continue
        z = normal[at : at + n].view(shape)
        at += n
        if key.endswith("embeddings.table"):
            out[key] = z.mul_(shape[1] ** -0.5)
        elif ".bn_" in key and leaf == "weight":
            out[key] = z.mul_(0.1).add_(1.0)
        elif ".bn_" in key and leaf in ("bias", "running_mean"):
            out[key] = z.mul_(0.1)
        elif leaf == "weight":
            out[key] = z.mul_(shape[1] ** -0.5)
        elif leaf == "bias":
            out[key] = z.mul_(0.01)
        else:
            raise ValueError(f"no rule for state_dict key {key!r}")
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
