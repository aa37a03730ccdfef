#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jodalrob_twotower_torch``) on one
NVIDIA card.

1. Builds every hand-written kernel from the checkout's sources, one nvcc
   process per source, all at once.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes its path gives it (bit-exact for the one-hot lookup;
   two calls bit-equal for the table gradient and the CE backward), and
   times kernel, plain version and the nearest library call beside the
   kernel's bound.
3. Serving phase: drives the serving path at full width - ``TrainConfig()``
   on ``reference_shaped_schema()`` (2.19M params), random weights from a
   seeded generator, a synthetic corpus of 1,000,000 companies - through
   ``RetrievalService`` (exact flat, and int8 chunked with a bf16 rescore),
   checks its answers against plain float32 scans, shows through the launch
   counters that the path ran the kernels, and measures throughput.
4. Training phase: the headline bench's workload (``jodalrob_twotower_torch.
   bench``: the same config at B=8192, 16 steps per call, stores and pairs
   on the card) for one warm-up and several timed calls; the launch counters
   show that the steps ran all four kernels; every loss must be finite and
   the last call's mean below the first's. Then one step's loss and
   gradients at B=1024 on the card against the same step on the CPU through
   the plain versions.

Run from the repository root: ``python3 chip_smoke.py``. Any failure exits
nonzero; so does a machine without a CUDA device. The second-to-last line is
the per-kernel JSON record, the last line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from jodalrob_twotower_torch import bench
from jodalrob_twotower_torch.config import LossConfig, TrainConfig
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.data.types import PairBatch, default_tower_gather
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.ops import _build
from jodalrob_twotower_torch.ops.embedding_grad import (
    dense_table_grad,
    dense_table_grad_plain,
    dense_table_lookup,
    dense_table_lookup_plain,
)
from jodalrob_twotower_torch.ops.fused_logits import (
    _bwd_constants,
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_lean_lse,
    fused_lean_lse_plain,
)
from jodalrob_twotower_torch.schema import reference_shaped_schema
from jodalrob_twotower_torch.serving.index import recall_vs_exact
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService, qps_bench
from jodalrob_twotower_torch.train.train_step import create_train_state, loss_and_grads, make_encode_fn
from jodalrob_twotower_torch.utils.flops import H100_PEAK_BF16_FLOPS

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), at the 700 W limit
KERNEL_SOURCES = ["onehot_lookup", "table_grad", "fused_ce_fwd", "fused_ce_bwd"]  # csrc/<name>.cu
LAUNCH_COUNTERS = (dense_table_lookup, dense_table_grad, fused_lean_lse, fused_ce_bwd)
TIMED_RUNS = 100
CE_BATCH, CE_DIM = 8192, 128  # the training path's loss shape
TRAIN_TIMED_CALLS = 10
GRAD_CHECK_BATCH = 1024
# stated tolerances, kernel against plain version on the card
LSE_ATOL = 1e-4  # lse of 8192 terms: f32 sums in another order, __expf (a few ulp)
CE_BWD_RTOL = 1e-3  # of max |plain|: A is rounded to bf16, an entry on a boundary may round apart
GRAD_ATOL = 1e-4  # f32 sums of <= a few hundred bf16 values of g ~ N(0, 1), another order
# one step, card against CPU: the loss within 2e-3 (bf16 activations); each
# gradient leaf within 1.5 times its own bf16 noise (the CPU's bf16 gradient
# against a float32 one) plus 0.005 (relative norms)
STEP_GRAD_NOISE_FACTOR = 1.5
STEP_GRAD_SLACK = 0.005
STEP_LOSS_ATOL = 2e-3
N_COMPANIES = 1_000_000
N_NOTICES = 20_000
QUERY_BATCH = 1024
TOP_K = 100
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def median_ms(fn, flush: torch.Tensor) -> float:
    """Median over TIMED_RUNS launches, each timed alone with CUDA events
    after the L2 cache is flushed (the bound assumes device-memory traffic).
    The flush keeps the card busy long enough for the host to enqueue the
    events and the launch behind it, so no host time falls between them."""
    fn()  # warm-up
    pairs = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# -- kernel phase --------------------------------------------------------------


def lookup_case(name: str, vocabs: tuple[int, ...], batch: int, table_dtype, gen, *, ragged: bool):
    """Inputs of the one-hot lookup at one of its paths' shapes."""
    offsets, total_rows = table_layout(vocabs)
    # ragged: ids also reach the block's alignment padding (in block, served)
    ids = np.stack([gen.integers(0, -(-v // 128) * 128 if ragged else v, size=batch) for v in vocabs], axis=1)
    rows = ids + offsets[None, :]
    if ragged:  # rows of other features' blocks, -1 padding, rows past the table
        k = len(vocabs)
        other = gen.random(rows.shape) < 0.1
        rows[other] = rows[other] + offsets[1] * gen.integers(1, k, size=int(other.sum()))
        rows[other] %= total_rows
        rows[gen.random(rows.shape) < 0.05] = -1
        rows[gen.random(rows.shape) < 0.01] = total_rows + 3
    table = torch.from_numpy(gen.normal(size=(total_rows, 32)).astype(np.float32))
    return {
        "case": name,
        "table": table.to("cuda", table_dtype),
        "rows": torch.from_numpy(rows.astype(np.int32)).to("cuda"),
        "tile_feature": torch.from_numpy(tile_feature_map(vocabs)).to("cuda"),
    }


def lookup_bytes(table, rows, tile_feature) -> int:
    """Least bytes the lookup must move: ids and tile map read, each
    referenced in-block table row read once, the bf16 output written."""
    b, k = rows.shape
    r, d = table.shape
    safe = rows.clamp(0, r - 1).long()
    in_block = (rows >= 0) & (rows < r) & (tile_feature[safe // 128] == torch.arange(k, device=rows.device))
    unique_rows = int(torch.unique(safe[in_block]).numel())
    return rows.numel() * 4 + tile_feature.numel() * 4 + unique_rows * d * table.element_size() + b * k * d * 2


def lookup_phase(flush: torch.Tensor) -> dict:
    gen = np.random.default_rng(SEED)
    schema = reference_shaped_schema()
    cases = [  # the training path's shapes first (its record reports the first), then serving's
        lookup_case("notice B=8192 K=32 R=32768", schema.notice.vocab_sizes, 8192, torch.float32, gen, ragged=False),
        lookup_case("notice B=1024 K=32 R=32768", schema.notice.vocab_sizes, 1024, torch.float32, gen, ragged=False),
        lookup_case("company B=8192 K=6 R=6144", schema.company.vocab_sizes, 8192, torch.float32, gen, ragged=False),
        lookup_case("ragged B=1000 K=32 R=32768", schema.notice.vocab_sizes, 1000, torch.float32, gen, ragged=True),
        lookup_case("ragged bf16 table B=1000 K=32", schema.notice.vocab_sizes, 1000, torch.bfloat16, gen, ragged=True),
    ]
    results = []
    for c in cases:
        args = (c["table"], c["rows"], c["tile_feature"])
        got = dense_table_lookup(*args)
        want = dense_table_lookup_plain(*args)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        rows_long = c["rows"].clamp(0, c["table"].shape[0] - 1).long()  # F.embedding takes no -1
        ms = median_ms(lambda: dense_table_lookup(*args), flush)
        plain_ms = median_ms(lambda: dense_table_lookup_plain(*args), flush)
        library_ms = median_ms(
            lambda: torch.nn.functional.embedding(rows_long, c["table"]).to(torch.bfloat16), flush
        )
        bound_ms = lookup_bytes(*args) / HBM_BYTES_PER_S * 1e3
        row = {"case": c["case"], "equal": equal, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms}
        print("kernel onehot_lookup", json.dumps(row), flush=True)
        check(equal, f"onehot_lookup != plain version, case {c['case']} (max abs err {err})")
        results.append(row)
    return {"onehot_lookup": results}


def unit_rows(gen: torch.Generator, b: int, d: int, device) -> torch.Tensor:
    x = torch.randn(b, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def ce_inputs(b: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Tower-like embeddings: unit rows, each positive near its row
    (tau = 1, the default, so N/tau = N and |S| <= 1)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = unit_rows(gen, b, d, device)
    c = n + 0.8 * unit_rows(gen, b, d, device)
    return n, c / c.norm(dim=1, keepdim=True)


def timed(row: dict, fn, plain, library, flush) -> dict:
    row["ms"] = median_ms(fn, flush)
    row["plain_ms"] = median_ms(plain, flush)
    row["library_ms"] = median_ms(library, flush)
    return row


def ce_fwd_phase(flush: torch.Tensor, b: int = CE_BATCH, d: int = CE_DIM) -> list[dict]:
    n, c = ce_inputs(b, d, "cuda")
    nb, cb = n.to(torch.bfloat16), c.to(torch.bfloat16)
    flops = 2 * b * b * d
    nbytes = 2 * b * d * 2 + 2 * b * 4
    rows = []
    for nomax in (True, False):
        got = fused_lean_lse(n, c, nomax=nomax)
        want = fused_lean_lse_plain(n, c, nomax=nomax)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        row = {"case": f"B={b} D={d} {'nomax' if nomax else 'shifted'}", "max_abs_err": err, "tolerance": LSE_ATOL,
               "bound_ms": max(flops / H100_PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
               "bound_by": "operations" if flops / H100_PEAK_BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes"}

        def library():
            s = (nb @ cb.T).float()
            return torch.logsumexp(s, 1), torch.logsumexp(s, 0)

        timed(row, lambda: fused_lean_lse(n, c, nomax=nomax), lambda: fused_lean_lse_plain(n, c, nomax=nomax),
              library, flush)
        print("kernel fused_ce_fwd", json.dumps(row), flush=True)
        check(err <= LSE_ATOL, f"fused_ce_fwd ({row['case']}) vs plain: max abs err {err} > {LSE_ATOL}")
        rows.append(row)
    # agreement only, at the step check's batch
    n, c = ce_inputs(GRAD_CHECK_BATCH, d, "cuda")
    for nomax in (True, False):
        got, want = fused_lean_lse(n, c, nomax=nomax), fused_lean_lse_plain(n, c, nomax=nomax)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        row = {"case": f"B={GRAD_CHECK_BATCH} D={d} {'nomax' if nomax else 'shifted'}", "max_abs_err": err,
               "tolerance": LSE_ATOL}
        print("kernel fused_ce_fwd", json.dumps(row), flush=True)
        check(err <= LSE_ATOL, f"fused_ce_fwd ({row['case']}) vs plain: max abs err {err} > {LSE_ATOL}")
        rows.append(row)
    return rows


def ce_bwd_phase(flush: torch.Tensor, b: int = CE_BATCH, d: int = CE_DIM) -> list[dict]:
    n, c = ce_inputs(b, d, "cuda")
    nb, cb = n.to(torch.bfloat16), c.to(torch.bfloat16)
    rl, cl = fused_lean_lse_plain(n, c, nomax=True)
    got = fused_ce_bwd(n, c, rl, cl)
    again = fused_ce_bwd(n, c, rl, cl)
    want = fused_ce_bwd_plain(n, c, rl, cl)
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(got, again))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    flops = 6 * b * b * d
    nbytes = 2 * b * d * 2 + 2 * b * 4 + 2 * b * d * 4
    inv2b, _, _ = _bwd_constants(b, 0.0)
    eye = torch.arange(b, device="cuda")

    def library():
        s = (nb @ cb.T).float()
        x = torch.exp(s - rl[:, None]) + torch.exp(s - cl[None, :])
        x[eye, eye] -= 2.0
        a = (inv2b * x).to(torch.bfloat16)
        return a @ cb, a.T @ nb

    row = {"case": f"B={b} D={d}", "two_calls_equal": equal, "max_abs_err": err, "max_rel_err": rel,
           "tolerance_rel": CE_BWD_RTOL,
           "bound_ms": max(flops / H100_PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
           "bound_by": "operations" if flops / H100_PEAK_BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes"}
    timed(row, lambda: fused_ce_bwd(n, c, rl, cl), lambda: fused_ce_bwd_plain(n, c, rl, cl), library, flush)
    print("kernel fused_ce_bwd", json.dumps(row), flush=True)
    check(equal, "fused_ce_bwd: two calls differ")
    check(rel <= CE_BWD_RTOL, f"fused_ce_bwd vs plain: max err {rel} of max |plain| > {CE_BWD_RTOL}")
    rows = [row]
    # agreement only: the second half of N as a row shard against all of C
    # (the diagonal at column row + offset), and the step check's batch
    half = b // 2
    shard = (n[half:], c, rl[half:], cl, 0.0, half)
    m, mc = ce_inputs(GRAD_CHECK_BATCH, d, "cuda")
    small = (m, mc, *fused_lean_lse_plain(m, mc, nomax=True))
    for case, args in ((f"rows {half}..{b} of B={b}, row_offset={half}", shard), (f"B={GRAD_CHECK_BATCH}", small)):
        got, again, want = fused_ce_bwd(*args), fused_ce_bwd(*args), fused_ce_bwd_plain(*args)
        rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        row = {"case": case, "two_calls_equal": all(torch.equal(x, y) for x, y in zip(got, again)),
               "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
               "max_rel_err": rel, "tolerance_rel": CE_BWD_RTOL}
        print("kernel fused_ce_bwd", json.dumps(row), flush=True)
        check(row["two_calls_equal"], f"fused_ce_bwd ({case}): two calls differ")
        check(rel <= CE_BWD_RTOL, f"fused_ce_bwd ({case}) vs plain: max err {rel} of max |plain| > {CE_BWD_RTOL}")
        rows.append(row)
    return rows


def table_grad_phase(flush: torch.Tensor, batch: int = 8192) -> list[dict]:
    """The table gradient at the training path's shapes: the ids of the
    bench's synthetic data (cluster-correlated, as the step sees them) and a
    bf16 cotangent ~ N(0, 1)."""
    gen = np.random.default_rng(SEED + 2)
    schema = reference_shaped_schema()
    ds = make_synthetic_dataset(schema, n_notices=20_000, n_companies=20_000, n_pairs=batch,
                                n_clusters=bench.N_CLUSTERS, seed=SEED)
    rows_out = []
    for name, side, store, col in (("notice", schema.notice, ds.notice_store, 0),
                                   ("company", schema.company, ds.company_store, 1)):
        offsets, total = table_layout(side.vocab_sizes)
        ids = store.cat_ids[ds.pairs[:, col]]
        rows = torch.from_numpy((ids + offsets[None, :]).astype(np.int32)).to("cuda")
        k = rows.shape[1]
        g = torch.from_numpy(gen.normal(size=(batch, k, 32)).astype(np.float32)).to("cuda", torch.bfloat16)
        tf = torch.from_numpy(tile_feature_map(side.vocab_sizes)).to("cuda")
        got = dense_table_grad(rows, g, tf)
        again = dense_table_grad(rows, g, tf)
        want = dense_table_grad_plain(rows, g, tf)
        torch.cuda.synchronize()
        equal = torch.equal(got, again)
        err = float((got - want).abs().max())
        nbytes = rows.numel() * 4 + g.numel() * 2 + total * 32 * 4 + tf.numel() * 4
        rows_flat, g_flat = rows.reshape(-1).long(), g.reshape(-1, 32)
        row = {"case": f"{name} B={batch} K={k} R={total} D=32", "two_calls_equal": equal, "max_abs_err": err,
               "tolerance": GRAD_ATOL, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        timed(row, lambda: dense_table_grad(rows, g, tf), lambda: dense_table_grad_plain(rows, g, tf),
              lambda: torch.zeros(total, 32, device="cuda").index_add_(0, rows_flat, g_flat.float()), flush)
        print("kernel table_grad", json.dumps(row), flush=True)
        check(equal, f"table_grad ({name}): two calls differ")
        check(err <= GRAD_ATOL, f"table_grad ({name}) vs plain: max abs err {err} > {GRAD_ATOL}")
        rows_out.append(row)
    # agreement only: a ragged batch whose ids reach other features' blocks,
    # their own block's padding, -1 and past the table; and a skewed batch
    # whose every id of a feature hits one row (one list of 8192 per row)
    vocabs = schema.notice.vocab_sizes
    ragged = lookup_case("ragged", vocabs, 1000, torch.float32, gen, ragged=True)
    skewed = np.broadcast_to(table_layout(vocabs)[0][None, :] + 7, (batch, len(vocabs)))
    tf = torch.from_numpy(tile_feature_map(vocabs)).to("cuda")
    for case, rows, scale in (("notice ragged B=1000", ragged["rows"], 1.0),
                              (f"notice skewed B={batch}", torch.from_numpy(skewed.astype(np.int32)).to("cuda"), 0.01)):
        g = torch.from_numpy(gen.normal(0.0, scale, size=(*rows.shape, 32)).astype(np.float32))
        g = g.to("cuda", torch.bfloat16)
        got, again, want = dense_table_grad(rows, g, tf), dense_table_grad(rows, g, tf), dense_table_grad_plain(rows, g, tf)
        row = {"case": case, "two_calls_equal": torch.equal(got, again),
               "max_abs_err": float((got - want).abs().max()), "tolerance": GRAD_ATOL}
        print("kernel table_grad", json.dumps(row), flush=True)
        check(row["two_calls_equal"], f"table_grad ({case}): two calls differ")
        check(row["max_abs_err"] <= GRAD_ATOL, f"table_grad ({case}) vs plain: max abs err {row['max_abs_err']}")
        rows_out.append(row)
    return rows_out


def kernel_phase(flush: torch.Tensor) -> dict:
    return {
        **lookup_phase(flush),
        "table_grad": table_grad_phase(flush),
        "fused_ce_fwd": ce_fwd_phase(flush),
        "fused_ce_bwd": ce_bwd_phase(flush),
    }


# -- serving phase -------------------------------------------------------------


def check_result(res, n_corpus: int, what: str) -> None:
    check(res.scores.shape == (QUERY_BATCH, TOP_K) and res.indices.shape == (QUERY_BATCH, TOP_K),
          f"{what}: result shape {res.scores.shape}")
    check(bool(np.isfinite(res.scores).all()), f"{what}: non-finite scores")
    check(bool((np.diff(res.scores, axis=1) <= 0).all()), f"{what}: scores not descending")
    check(bool(((res.indices >= 0) & (res.indices < n_corpus)).all()), f"{what}: index out of range")


def check_exact_vs_plain_scan(res, q: torch.Tensor, corpus: torch.Tensor) -> int:
    """The exact service's answer equals a plain float32 scan: scores within
    1e-5, index sets equal except where scores tie at the k-th place.
    Returns the number of rows whose sets differ at a tie."""
    ref_s, ref_i = torch.topk(q @ corpus.T, TOP_K, dim=1)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    check(bool(np.abs(res.scores - ref_s).max() <= 1e-5),
          f"exact scores vs plain scan: max diff {np.abs(res.scores - ref_s).max()}")
    ties = 0
    for r in range(QUERY_BATCH):
        diff = set(res.indices[r].tolist()) ^ set(ref_i[r].tolist())
        if diff:
            dots = (corpus[list(diff)] @ q[r]).cpu().numpy()
            check(bool(np.abs(dots - ref_s[r, -1]).max() <= 1e-5),
                  f"exact index set differs from plain scan beyond a tie, query row {r}")
            ties += 1
    return ties


def reset_counters() -> None:
    for counter in LAUNCH_COUNTERS:
        counter.launches = 0


def read_counters() -> dict[str, int]:
    return {c.__name__: c.launches for c in LAUNCH_COUNTERS}


def serving_phase() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products (the default), stated
    cfg = TrainConfig()
    schema = reference_shaped_schema()
    t0 = time.perf_counter()
    ds = make_synthetic_dataset(schema, n_notices=N_NOTICES, n_companies=N_COMPANIES, seed=SEED)
    data_s = time.perf_counter() - t0
    model = build_model(schema, cfg).init_weights(torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    state = FrozenState.from_model(model)
    gen = np.random.default_rng(SEED + 1)
    batches = [ds.notice_store.gather(gen.integers(0, N_NOTICES, size=QUERY_BATCH)) for _ in range(3)]
    print(f"serving: {n_params} params, {N_COMPANIES} companies, {N_NOTICES} notices "
          f"(synthetic data {data_s:.1f} s)", flush=True)

    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = RetrievalService(model, cfg, state, ds.company_store, index_kind="exact", device="cuda")
    torch.cuda.synchronize()
    exact_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8 = RetrievalService(
        model, cfg, state, ds.company_store, index_kind="int8", corpus_chunk=262_144,
        rescore_depth=400, rescore_dtype="bfloat16", device="cuda",
    )
    torch.cuda.synchronize()
    int8_build_s = time.perf_counter() - t0
    answers = []
    for b in batches:
        answers.append((exact.search(b, TOP_K), int8.search(b, TOP_K),
                        exact.search_keys(b, TOP_K), int8.search_keys(b, TOP_K)))
    torch.cuda.synchronize()
    launches = read_counters()
    print("serving main path launches", json.dumps(launches), flush=True)
    check(launches["dense_table_lookup"] > 0, "kernel dense_table_lookup was not launched on the serving path")

    # -- checks ----------------------------------------------------------------
    gather_model = build_model(
        schema, cfg.replace(model=dataclasses.replace(cfg.model, embedding_lookup="gather"))
    )
    encode_gather = make_encode_fn(gather_model, "notice")
    recalls, ties, emb_err = [], 0, 0.0
    for b, (res_e, res_8, keys_e, keys_8) in zip(batches, answers):
        check_result(res_e, N_COMPANIES, "exact")
        check_result(res_8, N_COMPANIES, "int8")
        q = exact.encode_queries(b)
        ties += check_exact_vs_plain_scan(res_e, q, exact.index.corpus)
        # int8 + bf16 rescore: returned scores are the bf16 dots of their rows
        idx = torch.from_numpy(res_8.indices).long().cuda()
        rows = int8.index.rescore_rows[idx].float()
        q8 = int8.encode_queries(b).to(torch.bfloat16).float()
        dots = (rows * q8[:, None, :]).sum(-1).cpu().numpy()
        check(bool(np.abs(dots - res_8.scores).max() <= 1e-5),
              f"int8 scores vs bf16 dots: max diff {np.abs(dots - res_8.scores).max()}")
        recalls.append(recall_vs_exact(res_8, res_e))
        check(recalls[-1] >= 0.9, f"int8 recall@{TOP_K} vs exact {recalls[-1]} < 0.9")
        keys = ds.company_store.keys
        check(keys_e[0][0][0] == str(keys[res_e.indices[0, 0]]), "exact search_keys disagree with search")
        check(keys_8[0][0][0] == str(keys[res_8.indices[0, 0]]), "int8 search_keys disagree with search")
        # the kernel path's notice embeddings equal the plain gather path's
        q_gather = encode_gather(exact.state, b.to("cuda"))
        emb_err = max(emb_err, float((q - q_gather).abs().max()))
        check(emb_err <= 1e-6, f"notice embeddings kernel vs gather path: max diff {emb_err}")
    print(f"serving checks: int8 recall@{TOP_K} vs exact {recalls}, exact rows tied at k: {ties}, "
          f"kernel vs gather embedding max diff {emb_err}", flush=True)

    # -- throughput ----------------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact._evaluator.encode_corpus(exact.state, ds.company_store.dense, ds.company_store.cat_ids)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    qps = {
        kind: qps_bench(svc, ds.notice_store, k=TOP_K, batch_size=QUERY_BATCH, n_batches=20)
        for kind, svc in (("exact", exact), ("int8", int8))
    }
    breakdown = {
        kind: device_breakdown(lambda svc=svc: svc.search(batches[0], TOP_K))
        for kind, svc in (("exact", exact), ("int8", int8))
    }
    for kind, row in breakdown.items():
        print(f"device time of one {kind} query batch " + json.dumps(row), flush=True)
    return {
        "params": n_params, "companies": N_COMPANIES, "notices": N_NOTICES,
        "launches": launches, "recall_int8_vs_exact": recalls,
        "exact_service_build_s": exact_build_s, "int8_service_build_s": int8_build_s,
        "corpus_encode_s": encode_s,
        "qps_exact": qps["exact"]["qps"], "ms_per_batch_exact": qps["exact"]["latency_ms_per_batch"],
        "qps_int8": qps["int8"]["qps"], "ms_per_batch_int8": qps["int8"]["latency_ms_per_batch"],
        "device_busy_share": {kind: row["busy_share"] for kind, row in breakdown.items()},
    }


def device_breakdown(fn, repeats: int = 3, top: int = 8, host_top: int = 0) -> dict:
    """Where one call of ``fn`` (a query batch, a training call) spends its
    time: torch.profiler's CUDA events (kernels and copies) over ``repeats``
    serial calls, summed by name, and the card's busy share of the wall
    time; with ``host_top``, also the host operators with the most self CPU
    time (profiled, so inflated by the profiler's own cost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    n_events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / repeats
            n_events += 1
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms_per_call": wall_us / repeats / 1e3,
        "device_ms_per_call": busy_us / 1e3,
        "busy_share": busy_us * repeats / wall_us if busy_us else None,
        "device_events_per_call": n_events / repeats,
        "top_ms": {name: us / 1e3 for name, us in ranked},
        "host_top": [
            {"op": a.key[:60], "calls": a.count / repeats, "self_cpu_ms": a.self_cpu_time_total / repeats / 1e3}
            for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
        ],
    }


# -- training phase ---------------------------------------------------------------


def training_phase() -> dict:
    """The headline bench's workload on the card: one warm-up call and
    TRAIN_TIMED_CALLS timed calls of 16 steps at B=8192, the launch counters
    read around them, then a profiler breakdown of one more call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    work = bench.build_workload(device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in work.state.params.values())
    print(f"training: {n_params} params, B={work.batch_size}, "
          f"{bench.N_NOTICES} notices x {bench.N_COMPANIES} companies, {bench.N_PAIRS} pairs "
          f"(data and upload {work.data_s:.1f} s)", flush=True)

    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = work.call(0)["loss"].cpu().numpy()
    warm_s = time.perf_counter() - t0
    out = bench.timed_calls(work, TRAIN_TIMED_CALLS)
    torch.cuda.synchronize()
    launches = read_counters()
    print("training main path launches", json.dumps(launches), flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the training path")
    losses = np.asarray([first.tolist()] + out["losses"])
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(float(losses[-1].mean()) < float(losses[0].mean()),
          f"training loss did not decrease: first call {losses[0].mean()}, last {losses[-1].mean()}")
    breakdown = device_breakdown(
        lambda: work.call(10_000 + work.state.step)["loss"].cpu(), repeats=1, top=12, host_top=12
    )
    print("device time of one training call " + json.dumps(breakdown), flush=True)
    return {
        "params": n_params, "batch": work.batch_size, "steps_per_call": len(first),
        "timed_calls": TRAIN_TIMED_CALLS, "warmup_call_s": warm_s,
        "examples_per_sec": out["examples_per_sec"], "ms_per_step": out["ms_per_step"], "mfu": out["mfu"],
        "call_ms": out["call_ms"],
        "model_gflops_per_step": out["model_gflops_per_step"],
        "loss_first_call": float(losses[0].mean()), "loss_last_call": float(losses[-1].mean()),
        "launches": launches, "launches_per_step": {k: v / losses.size for k, v in launches.items()},
        "device_busy_share": breakdown["busy_share"], "device_ms_per_call": breakdown["device_ms_per_call"],
        # the profiled call's device time over the unprofiled calls' wall time
        "device_busy_share_timed": breakdown["device_ms_per_call"] / (out["ms_per_step"] * len(first)),
        "device_events_per_call": breakdown["device_events_per_call"], "host_top": breakdown["host_top"],
        "wall_ms_per_call": breakdown["wall_ms_per_call"], "top_ms": breakdown["top_ms"],
    }


def step_grad_check() -> dict:
    """One training-form step at B=GRAD_CHECK_BATCH, dropout 0, from the same
    state and pairs: on the card (the kernels) and on the CPU (their plain
    versions: the config forces the one-hot lookup and the fused loss, so
    both run the same functions), plus a float32 reference on the CPU (f32
    towers, gather lookup, materialized f32 loss) that calibrates bf16's own
    noise. Gradients, not post-Adam params, since the first Adam step is
    about lr * sign(g) and a gradient near zero may take either sign. Each
    leaf's card gradient must lie within STEP_GRAD_NOISE_FACTOR times that
    leaf's own bf16 noise (the CPU bf16 gradient's distance from the f32
    one), plus STEP_GRAD_SLACK, of the CPU gradient (relative norms). The
    noise is measured from the gradient, so a leaf whose gradient is zero up
    to rounding (the bias of a layer that feeds a training-form BatchNorm,
    where the ReLU passes the whole batch) gets the wide tolerance its
    rounding earns and every other leaf a tight one; no leaf is exempt."""
    base = TrainConfig().model
    cfg = TrainConfig(
        model=dataclasses.replace(base, dropout_rate=0.0, embedding_lookup="onehot"),
        loss=LossConfig(use_fused_logits=True),
    )
    cfg32 = TrainConfig(
        model=dataclasses.replace(base, dropout_rate=0.0, compute_dtype="float32", embedding_lookup="gather"),
        loss=LossConfig(use_fused_logits=False),
    )
    schema = reference_shaped_schema()
    ds = make_synthetic_dataset(schema, n_notices=20_000, n_companies=20_000, n_pairs=GRAD_CHECK_BATCH,
                                n_clusters=bench.N_CLUSTERS, seed=SEED + 3)
    model = build_model(schema, cfg).init_weights(torch.Generator().manual_seed(SEED + 3))
    model32 = build_model(schema, cfg32)
    model32.load_state_dict(model.state_dict())
    results = {}
    for run, device, m, c in (("card", "cuda", model, cfg), ("cpu", "cpu", model, cfg), ("f32", "cpu", model32, cfg32)):
        state, _ = create_train_state(m, c, SEED, 1000, device=device)
        stores = [
            (torch.from_numpy(st.dense).to(torch.bfloat16).to(device), torch.from_numpy(st.cat_ids).to(device))
            for st in (ds.notice_store, ds.company_store)
        ]
        idx = torch.from_numpy(ds.pairs).to(device)
        batch = PairBatch(default_tower_gather(stores[0], idx[:, 0]), default_tower_gather(stores[1], idx[:, 1]))
        loss, _, grads = loss_and_grads(m, c, state, batch)
        results[run] = (float(loss), {k: g.float().cpu() for k, g in grads.items()})

    def rel(a: str, b: str) -> dict[str, float]:
        ref = results[b][1]
        return {k: float((g - ref[k]).norm() / ref[k].norm().clamp_min(1e-30)) for k, g in results[a][1].items()}

    card_vs_cpu, card_vs_f32, cpu_vs_f32 = rel("card", "cpu"), rel("card", "f32"), rel("cpu", "f32")
    tolerance = {k: STEP_GRAD_NOISE_FACTOR * v + STEP_GRAD_SLACK for k, v in cpu_vs_f32.items()}
    share = {k: card_vs_cpu[k] / tolerance[k] for k in tolerance}
    worst = max(share, key=share.get)
    loss_err = abs(results["card"][0] - results["cpu"][0])
    leaves = {k: {"card_vs_cpu": card_vs_cpu[k], "cpu_bf16_vs_f32": cpu_vs_f32[k], "card_vs_f32": card_vs_f32[k],
                  "tolerance": tolerance[k]} for k in sorted(share, key=share.get, reverse=True)}
    print("step gradient leaves " + json.dumps(leaves), flush=True)
    row = {"batch": GRAD_CHECK_BATCH, "loss_card": results["card"][0], "loss_cpu": results["cpu"][0],
           "loss_f32": results["f32"][0], "loss_abs_err": loss_err, "loss_tolerance": STEP_LOSS_ATOL,
           "max_grad_rel_err": max(card_vs_cpu.values()), "max_grad_rel_err_leaf": max(card_vs_cpu, key=card_vs_cpu.get),
           "worst_leaf_vs_tolerance": worst, "worst_card_vs_cpu": card_vs_cpu[worst],
           "worst_tolerance": tolerance[worst], "worst_share_of_tolerance": share[worst]}
    print("step card vs cpu " + json.dumps(row), flush=True)
    check(loss_err <= STEP_LOSS_ATOL, f"step loss card vs CPU: {loss_err} > {STEP_LOSS_ATOL}")
    check(share[worst] <= 1.0,
          f"step gradient {worst}: card vs CPU {card_vs_cpu[worst]} > tolerance {tolerance[worst]}")
    return row


def kernel_record(name: str, source: str, replaces: str, rows: list[dict], launches: dict, counter: str) -> dict:
    main = rows[0]  # the main path's shape comes first
    rec = {
        "name": name, "route": "cuda", "source": f"jodalrob_twotower_torch/csrc/{source}",
        "replaces": replaces, "launches": launches["training"][counter],
        "launches_by_path": {path: counts[counter] for path, counts in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main.get("bound_by", "bytes"), "library_ms": main["library_ms"], "cases": rows,
    }
    if "equal" in main:
        rec["equal"] = all(r["equal"] for r in rows)
    if "two_calls_equal" in main:
        rec["two_calls_equal"] = all(r["two_calls_equal"] for r in rows)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    card = bench.card_line()
    print(card, flush=True)  # name, power limit: every number below is this card's
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        _build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {KERNEL_SOURCES}", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", flush=True)

    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    kernels = kernel_phase(flush)
    del flush
    serving = serving_phase()
    serving["card"] = card
    print("serving " + json.dumps(serving), flush=True)
    training = training_phase()
    training["card"] = card
    print("training " + json.dumps(training), flush=True)
    step_check = step_grad_check()

    launches = {"serving": serving["launches"], "training": training["launches"]}
    record = {"kernels": [
        kernel_record("onehot_lookup", "onehot_lookup.cu", "jodalrob_twotower_tpu/ops/embedding_grad.py:358",
                      kernels["onehot_lookup"], launches, "dense_table_lookup"),
        kernel_record("table_grad", "table_grad.cu", "jodalrob_twotower_tpu/ops/embedding_grad.py:45",
                      kernels["table_grad"], launches, "dense_table_grad"),
        kernel_record("fused_ce_fwd", "fused_ce_fwd.cu", "jodalrob_twotower_tpu/ops/fused_logits.py:280",
                      kernels["fused_ce_fwd"], launches, "fused_lean_lse"),
        kernel_record("fused_ce_bwd", "fused_ce_bwd.cu", "jodalrob_twotower_tpu/ops/fused_logits.py:819",
                      kernels["fused_ce_bwd"], launches, "fused_ce_bwd"),
    ], "training": {k: training[k] for k in ("examples_per_sec", "ms_per_step", "mfu", "device_busy_share",
                                         "device_busy_share_timed")},
        "step_check": {k: step_check[k] for k in ("loss_abs_err", "max_grad_rel_err", "worst_share_of_tolerance")},
        "card": card}
    record["kernels"][2]["also_replaces"] = "jodalrob_twotower_tpu/ops/fused_logits.py:241"
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
