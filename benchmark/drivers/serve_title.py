"""The serving driver for a notice tower that encodes its title on the card:
``drivers/serve.py``'s service, index, arrivals and window, with each
notice's title as token ids and lengths in its ``TowerBatch``, so that
every ``search_device`` runs the program's text encoder
(``models/text_encoder.py``) before the tower and the scan.

Titles are made from the seed on the card (:func:`make_titles`): a length
per notice, lognormal around ``length_median``, clipped to
[``min_length``, max_length]; each id from the notice's cluster's own
``cluster_slice`` ids with probability ``cluster_share``, else Zipf(``zipf_s``)
over the vocabulary in a rank order drawn from the seed.

The model is built on the meta device and its weights assigned: the towers'
from ``gen.make_weights`` (every key but the encoder's), the encoder's
drawn one piece at a time (``gen_kanana.py``) and cast to the compute dtype,
so that no float32 copy of the encoder is ever whole on the card.

After the window the check batches are drawn from the seed, the program's
pooled title vectors for them computed once more by its encoder, with each
MoE layer's chosen experts caught by a hook on its router, and the
program's state freed. The reference then encodes those titles in float32
layer by layer (``reference/kanana.py``) twice: routed by its own scores,
then its notice tower and an exact scan of the corpus, for ``score_gap``
and ``rank_gap`` (``drivers/serve.py``'s, on the timed path's own answers);
and routed as the program routed, for ``text_gap``, the widest |pooled -
reference| / |reference| over the checked titles (:func:`text_gaps`). With
the routing pinned, ``text_gap`` reads the encoder's arithmetic, which a
near-tie between a token's 6th and 7th expert (routed apart by any
precision below float32) does not move; the routing itself is held by the
answers' check, whose reference routes by its own scores.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import flops_kanana, gen, gen_kanana, judge, spec
from benchmark.drivers import common, serve
from benchmark.drivers.common import Clock
from benchmark.reference import kanana as ref_kanana
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.evaluation.evaluator import Evaluator
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.ops import moe
from jodalrob_twotower_torch.schema import EncodedTextSpec, TwoTowerSchema
from jodalrob_twotower_torch.serving.index import HostCopy
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService

ENCODER_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
                "first_k_dense_replace", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "n_shared_experts", "num_experts_per_tok",
                "routed_scaling_factor", "norm_topk_prob", "rope_theta", "rms_norm_eps")


def encoded_column(cfg_spec: dict) -> tuple[str, dict]:
    (name, enc), = cfg_spec["schema"]["notice"]["encoded_text"].items()
    return name, enc


def program_schema(cfg_spec: dict) -> TwoTowerSchema:
    """``common.program_schema`` with the notice's encoded title column,
    its encoder's sizes the config file's."""
    base = common.program_schema(cfg_spec["schema"])
    name, enc = encoded_column(cfg_spec)
    overrides = tuple(sorted((k, cfg_spec[k]) for k in ENCODER_KEYS))
    col = EncodedTextSpec(name, enc["encoder"], enc["max_length"], enc["embed_dim"], overrides)
    return TwoTowerSchema(notice=dataclasses.replace(base.notice, encoded_text=(col,)), company=base.company)


def encoder_prefix(cfg_spec: dict) -> str:
    return f"notice_tower.encoder_{encoded_column(cfg_spec)[0]}."


def meta_state(cfg_spec: dict) -> dict:
    """The program's state_dict on the meta device: every key's shape and dtype."""
    with torch.device("meta"):
        return build_model(program_schema(cfg_spec), common.program_config(cfg_spec)).state_dict()


def tower_weights(cfg_spec: dict, seed: int, device) -> dict:
    """The towers' float32 weights for ``seed`` (every key but the
    encoder's), keyed as the program's."""
    prefix = encoder_prefix(cfg_spec)
    shapes = {k: tuple(v.shape) for k, v in meta_state(cfg_spec).items() if not k.startswith(prefix)}
    return gen.make_weights(shapes, spec.derive(seed, "weights"), device)


def program_model(cfg_spec: dict, seed: int, device):
    """(model on the meta device, FrozenState): the towers' weights and the
    encoder's, drawn a piece at a time and cast to its parameters' dtypes."""
    with torch.device("meta"):
        model = build_model(program_schema(cfg_spec), common.program_config(cfg_spec))
    meta = model.state_dict()
    prefix = encoder_prefix(cfg_spec)
    weights = tower_weights(cfg_spec, seed, device)
    for piece in gen_kanana.pieces(cfg_spec):
        for k, v in gen_kanana.draw(cfg_spec, spec.derive(seed, "kanana"), piece, device).items():
            weights[prefix + k] = v.to(meta[prefix + k].dtype)
            del v
    missing, extra = set(meta) - set(weights), set(weights) - set(meta)
    if missing or extra:
        raise KeyError(f"weights and the model differ: missing {sorted(missing)[:4]}, extra {sorted(extra)[:4]}")
    return model, FrozenState(weights)


def notice_clusters(schema: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """Each notice's latent cluster, as ``gen.make_data`` draws it for
    ``seed``: its first draws replayed (the centroids, the notice side's
    text centroids, the notice store)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_clusters = traffic["n_clusters"]
    centroids = torch.randn((n_clusters, gen.CENTROID_DIM), generator=g, device=device)
    side = schema["notice"]
    text_centroids = [torch.randn((n_clusters, d), generator=g, device=device) for d in side["text"].values()]
    return gen.side_store(g, side, traffic["n_notices"], traffic, centroids, text_centroids, device)[2]


def make_titles(cfg_spec: dict, traffic: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [n_notices, max_length] right-padded with 0, lengths int32
    [n_notices]) for ``seed`` (module docstring)."""
    t = traffic["title"]
    _, enc = encoded_column(cfg_spec)
    n_max, vocab = enc["max_length"], cfg_spec["vocab_size"]
    cluster = notice_clusters(cfg_spec["schema"], traffic, spec.derive(seed, "data"), device)
    n = cluster.shape[0]
    g = torch.Generator(device=device).manual_seed(spec.derive(seed, "titles"))
    raw = t["length_median"] * torch.exp(t["length_sigma"] * torch.randn(n, generator=g, device=device))
    lengths = raw.round().clamp(t["min_length"], n_max).to(torch.int32)
    rank_to_id = torch.randperm(vocab, generator=g, device=device)
    pz = torch.arange(1, vocab + 1, device=device, dtype=torch.float64) ** -t["zipf_s"]
    cdf = torch.cumsum(pz, 0) / pz.sum()
    u = torch.rand((n, n_max), generator=g, device=device, dtype=torch.float64)
    zipf = rank_to_id[torch.searchsorted(cdf, u).clamp(max=vocab - 1)]
    slices = torch.randint(0, vocab, (traffic["n_clusters"], t["cluster_slice"]), generator=g, device=device)
    pick = torch.randint(0, t["cluster_slice"], (n, n_max), generator=g, device=device)
    own = torch.rand((n, n_max), generator=g, device=device) < t["cluster_share"]
    ids = torch.where(own, slices[cluster[:, None], pick], zipf)
    ids = torch.where(torch.arange(n_max, device=device)[None, :] < lengths[:, None], ids, 0)
    return ids.to(torch.int32), lengths


class Run(serve.Run):
    def __init__(self, cell: dict, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg_spec, self.traffic = cell["config_spec"], cell["traffic_spec"]
        t = self.traffic
        self.k, self.batch = t["k"], t["batch_size"]
        clock = Clock()
        cfg = common.program_config(self.cfg_spec)
        data = gen.make_data(self.cfg_spec["schema"], t, spec.derive(seed, "data"), self.device)
        titles = make_titles(self.cfg_spec, t, seed, self.device)
        clock("data")
        model, state = program_model(self.cfg_spec, seed, self.device)
        clock("weights")
        corpus = Evaluator(model, cfg).encode_corpus_device(state, data["company"], t["n_companies"],
                                                            chunk=t["encode_chunk"])
        del data["company"]
        clock("corpus encoded")
        self.service = RetrievalService(
            model, cfg, state, None, index_kind=t["index"], corpus_chunk=t["corpus_chunk"],
            rescore_depth=t.get("rescore_depth"), rescore_dtype=t.get("rescore_dtype", "int8"),
            precomputed_corpus_emb=corpus, device=self.device)
        del corpus, state
        clock("index")
        self.notices = [x.cpu().numpy() for x in (*data["notice"], *titles)]
        self.rng = np.random.default_rng(spec.derive(seed, "queries"))
        self.answers: dict[int, tuple] = {}
        self.n_due = 0
        self.check = None
        for _ in range(t.get("warm_batches", 3)):
            HostCopy(*self._search(self._rows())).result()
        self.phases = clock("notices to the host, warm batches")

    def _batch(self, rows: np.ndarray) -> TowerBatch:
        return TowerBatch(*(x[rows] for x in self.notices))

    def _search(self, rows: np.ndarray):
        return self.service.search_device(self._batch(rows), self.k)

    def _tally(self) -> np.ndarray:
        c = self.cfg_spec
        return moe.expert_tally(c["num_hidden_layers"] - c["first_k_dense_replace"], c["n_routed_experts"])

    def traced_window(self, traced) -> dict:
        """``serve.Run.traced_window``'s passes; the model FLOPs are the
        titles' real tokens through the encoder (``flops_kanana``), the tower
        and the scan, over the untraced pass's seconds (a backlog); the
        expert-load counter is read around the card-only pass."""
        n = self.traffic["trace_batches"]
        due_before = self.n_due

        def one_pass():
            first, before = self.n_due, self._tally()
            r = self._serve(n=n)
            r["batches_sent"] = range(first, self.n_due)
            r["tally"] = self._tally() - before
            return r

        runs, summary = traced(one_pass)
        lengths = self.notices[3]
        plain = [int(n_) for b in runs[0]["batches_sent"] for n_ in lengths[self.answers[b][0]]]
        summary.update(model_flops=flops_kanana.serve_batch_flops(self.cfg_spec, plain, self.traffic["n_companies"]),
                       flops_s=summary["plain_window_s"])
        c, tally = self.cfg_spec, runs[1]["tally"]
        summary["encoder"] = {
            "layers": c["num_hidden_layers"], "heads": c["num_attention_heads"], "nope": c["qk_nope_head_dim"],
            "rope": c["qk_rope_head_dim"], "v_dim": c["v_head_dim"], "hidden": c["hidden_size"],
            "inter": c["moe_intermediate_size"], "top_k": c["num_experts_per_tok"], "experts": c["n_routed_experts"],
            "batches": len(runs[1]["batches_sent"]), "batch": self.batch, "seq": self.notices[2].shape[1],
            "pairs": tally[:, :, 0].sum(1).tolist(), "touched": tally[:, :, 1].sum(1).tolist(),
            "load": tally[:, :, 0].tolist()}
        summary.update(attempted=(self.n_due - due_before) * self.batch,
                       failed=sum(r["batches"] - len(r["latencies"]) for r in runs) * self.batch)
        return summary

    def release(self) -> None:
        """Draws the check batches and keeps the program's pooled title
        vectors for them and each MoE layer's chosen experts (its encoder,
        as the timed path runs it), then frees the program's state."""
        picked = serve.sample_batches(self.answers, self.traffic["check_batches"], self.seed)
        if picked and self.service is not None:
            encoder = self.service.model.notice_tower.get_submodule(f"encoder_{encoded_column(self.cfg_spec)[0]}")
            prefix = encoder_prefix(self.cfg_spec)
            weights = {k[len(prefix):]: v for k, v in self.service.state.state_dict.items() if k.startswith(prefix)}
            routers = [layer.mlp.gate for layer in encoder.layers if not layer.dense]
            routes = [[] for _ in routers]
            hooks = [r.register_forward_hook(lambda m, a, out, j=j: routes[j].append(out[1].to(torch.int16).cpu()))
                     for j, r in enumerate(routers)]
            pooled = []
            try:
                with torch.inference_mode():
                    for b in picked:
                        tb = self._batch(self.answers[b][0]).to(self.device)
                        pooled.append(
                            torch.func.functional_call(encoder, weights, (tb.text_ids, tb.text_lengths)).cpu())
            finally:
                for h in hooks:
                    h.remove()
            self.check = (picked, torch.cat(pooled), [torch.cat(r) for r in routes])
        self.service = None

    def judge(self) -> dict:
        if self.check is None:
            return {"score_gap": float("inf"), "rank_gap": float("inf"), "text_gap": float("inf")}
        return judge_answers(self.cell, self.seed, self.device, self.answers, *self.check, self.notices)


def reference_pooled(cell: dict, seed: int, device, rows: np.ndarray, notices, prec: str = "f32", routes=None,
                     record: list | None = None) -> torch.Tensor:
    """The reference's pooled title vectors [Q, H] for the rows, in
    ``prec``; ``routes`` and ``record`` are ``reference/kanana.encode``'s."""
    ids = torch.as_tensor(notices[2][rows], device=device)
    lengths = torch.as_tensor(notices[3][rows], device=device)
    return ref_kanana.encode(cell["config_spec"], spec.derive(seed, "kanana"), ids, lengths, prec=prec, routes=routes,
                             record=record)


def reference_encode(cell: dict, seed: int, device, rows: np.ndarray, notices, w: dict, prec: str = "f32",
                     record: list | None = None):
    """(pooled [Q, H], queries [Q, final]): the reference's encoder on the
    rows' titles, routed by its own scores, then its notice tower, in
    ``prec``."""
    cfg_spec = cell["config_spec"]
    pooled = reference_pooled(cell, seed, device, rows, notices, prec, record=record)
    dense = torch.as_tensor(notices[0][rows], device=device)
    cat = torch.as_tensor(notices[1][rows], device=device)
    side = flops_kanana.reference_side(cfg_spec["schema"]["notice"])
    q = ref_model.tower(w, "notice", side, cfg_spec["train_config"]["model"], torch.cat([dense, pooled], 1), cat,
                        train=False, prec=prec)
    return pooled, q


def reference_corpus(cell: dict, seed: int, device, w: dict, prec: str = "f32"):
    cfg_spec, traffic = cell["config_spec"], cell["traffic_spec"]
    data = gen.make_data(cfg_spec["schema"], traffic, spec.derive(seed, "data"), device)
    return ref_serve.encode(w, "company", cfg_spec["schema"]["company"], cfg_spec["train_config"]["model"],
                            *data["company"], prec=prec)


def text_gaps(pooled: torch.Tensor, pinned: torch.Tensor, own: torch.Tensor) -> dict:
    """``text_gap``: the widest over the titles of |pooled - pinned| /
    |pinned|, ``pinned`` the reference routed as ``pooled`` was;
    ``_text_gap_median`` (printed) its median; ``_text_gap_own_routing``
    (printed) the median against ``own``, the reference routed by its own
    scores, which routing near-ties move."""
    def rel(ref):
        return (pooled.float() - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)

    pinned_rel = rel(pinned)
    return {"text_gap": float(pinned_rel.max()), "_text_gap_median": float(pinned_rel.median()),
            "_text_gap_own_routing": float(rel(own).median())}


def judge_answers(cell: dict, seed: int, device, answers: dict, picked: list, pooled, routes, notices) -> dict:
    """``score_gap``, ``rank_gap`` (``drivers/serve.py``'s) and ``text_gap``
    over the picked batches, ``routes`` the program's chosen experts for
    them; a malformed answer reads as infinite gaps."""
    t = cell["traffic_spec"]
    w = tower_weights(cell["config_spec"], seed, device)
    corpus = reference_corpus(cell, seed, device, w)
    rows = np.concatenate([answers[b][0] for b in picked])
    scores = torch.as_tensor(np.concatenate([answers[b][1] for b in picked]), device=device)
    served = torch.as_tensor(np.concatenate([answers[b][2] for b in picked]), device=device).long()
    ref_pooled, q = reference_encode(cell, seed, device, rows, notices, w)
    pinned = reference_pooled(cell, seed, device, rows, notices, routes=routes)
    gaps = text_gaps(pooled.to(device), pinned, ref_pooled)
    if not serve.answers_well_formed(scores, served, corpus.shape[0], t["k"]):
        return {"score_gap": float("inf"), "rank_gap": float("inf"), **gaps}
    best, _ = ref_serve.exact_topk(q, corpus, t["k"])
    return {**judge.serve_numbers(scores, served, best, ref_serve.scores_of(q, corpus, served)), **gaps}


def control(cell: dict, seed: int, device, n_queries: int | None = None) -> dict:
    """The control's numbers (``drivers/serve.control``'s, with the encoder
    in float8 too) on ``n_queries`` titles drawn from the seed, by default
    ``check_batches`` batches of the traffic; its ``text_gap`` against the
    float32 reference routed as the float8 one routed."""
    t = cell["traffic_spec"]
    n_queries = n_queries or t["check_batches"] * t["batch_size"]
    cfg_spec = cell["config_spec"]
    data = gen.make_data(cfg_spec["schema"], t, spec.derive(seed, "data"), device)
    notices = [x.cpu().numpy() for x in (*data["notice"], *make_titles(cfg_spec, t, seed, device))]
    del data
    rows = np.random.default_rng(spec.derive(seed, "queries")).integers(0, t["n_notices"], n_queries)
    w = tower_weights(cfg_spec, seed, device)
    corpus = reference_corpus(cell, seed, device, w)
    pooled, q = reference_encode(cell, seed, device, rows, notices, w)
    best, _ = ref_serve.exact_topk(q, corpus, t["k"])
    corpus_c = reference_corpus(cell, seed, device, w, prec="fp8")
    routes_c = []
    pooled_c, q_c = reference_encode(cell, seed, device, rows, notices, w, prec="fp8", record=routes_c)
    pinned = reference_pooled(cell, seed, device, rows, notices, routes=routes_c)
    if t["index"] == "int8":
        s_c, i_c = ref_serve.int4_rescored_topk(q_c, corpus_c, t["k"], t["rescore_depth"])
    else:
        s_c, i_c = ref_serve.exact_topk(q_c, corpus_c, t["k"], prec="tf32")
    return {**judge.serve_numbers(s_c, i_c, best, ref_serve.scores_of(q, corpus, i_c)),
            **text_gaps(pooled_c, pinned, pooled)}
