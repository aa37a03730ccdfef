"""In-batch ranking metrics (port of ``jodalrob_twotower_tpu/train/metrics.py``).

Top-1 accuracy, recall@k, MRR, AUC and the positive/negative similarity gap
over a [B, B] similarity matrix with the true match on the diagonal. They
serve the materialized loss path (``with_metrics=True``) and are the plain
reference for the fused stats kernel of a later slice.
"""

from __future__ import annotations

import torch


def diagonal_ranks(sim: torch.Tensor) -> torch.Tensor:
    """0-based rank of the diagonal entry within each row (ties favour the
    positive)."""
    diag = torch.diagonal(sim)
    return (sim > diag[:, None]).sum(-1)


def in_batch_metrics(sim: torch.Tensor, recall_ks: tuple[int, ...] = (5, 10)) -> dict[str, torch.Tensor]:
    """All in-batch metrics from a [B, B] similarity matrix, as 0-dim f32 tensors."""
    b = sim.shape[0]
    ranks = diagonal_ranks(sim).float()
    diag = torch.diagonal(sim)
    mean_all = sim.mean(-1)
    # mean over the B-1 off-diagonal candidates per row
    neg_mean = (mean_all * b - diag) / max(b - 1, 1)
    metrics = {
        "accuracy": (ranks == 0).float().mean(),
        "mrr": (1.0 / (ranks + 1.0)).mean(),
        # P(the positive scores above a random negative): rank r = r of the B-1 negatives beat it
        "auc": (1.0 - ranks / max(b - 1, 1)).mean(),
        "positive_similarity": diag.mean(),
        "negative_similarity": neg_mean.mean(),
    }
    metrics["similarity_gap"] = metrics["positive_similarity"] - metrics["negative_similarity"]
    metrics["z_gap"] = metrics["similarity_gap"] / (metrics["negative_similarity"].abs() + 1e-8)
    for k in recall_ks:
        metrics[f"recall@{k}"] = (ranks < k).float().mean()
    return metrics


def random_baselines(batch_size: int, recall_ks: tuple[int, ...] = (5, 10)) -> dict[str, float]:
    """Expected values of the in-batch metrics for a random scorer."""
    out = {"accuracy": 1.0 / batch_size}
    out.update({f"recall@{k}": min(k / batch_size, 1.0) for k in recall_ks})
    # E[MRR] = H(B)/B for a uniform random rank
    out["mrr"] = float(sum(1.0 / r for r in range(1, batch_size + 1)) / batch_size)
    return out
