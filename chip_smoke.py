#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jodalrob_twotower_torch``) on one
NVIDIA card.

1. Builds every hand-written kernel from the checkout's sources.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it (bit-exact for the one-hot
   lookup), and times kernel, plain version and the nearest library call.
3. Serving phase: drives the serving path at full width - ``TrainConfig()``
   on ``reference_shaped_schema()`` (2.19M params), random weights from a
   seeded generator, a synthetic corpus of 1,000,000 companies - through
   ``RetrievalService`` (exact flat, and int8 chunked with a bf16 rescore),
   checks its answers against plain float32 scans, shows through the launch
   counters that the path ran the kernels, and measures throughput.

Run from the repository root: ``python3 chip_smoke.py``. Any failure exits
nonzero; so does a machine without a CUDA device. The second-to-last line is
the per-kernel JSON record, the last line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.ops import _build
from jodalrob_twotower_torch.ops.embedding_grad import (
    dense_table_lookup,
    dense_table_lookup_plain,
)
from jodalrob_twotower_torch.schema import reference_shaped_schema
from jodalrob_twotower_torch.serving.index import recall_vs_exact
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService, qps_bench
from jodalrob_twotower_torch.train.train_step import make_encode_fn

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), at the 700 W limit
KERNEL_SOURCES = ["onehot_lookup"]  # csrc/<name>.cu
TIMED_RUNS = 100
N_COMPANIES = 1_000_000
N_NOTICES = 20_000
QUERY_BATCH = 1024
TOP_K = 100
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    """Inputs of the one-hot lookup at one of the serving path's shapes."""
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
        "rows": torch.from_numpy(rows.astype(np.int32)).cuda(),
        "tile_feature": torch.from_numpy(tile_feature_map(vocabs)).cuda(),
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


def kernel_phase(flush: torch.Tensor) -> dict:
    gen = np.random.default_rng(SEED)
    schema = reference_shaped_schema()
    cases = [
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


def serving_phase(launch_counters) -> dict:
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
    for counter in launch_counters:
        counter.launches = 0
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
    launches = {c.__name__: c.launches for c in launch_counters}
    print("serving main path launches", json.dumps(launches), flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")

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
    breakdown = {kind: device_breakdown(svc, batches[0]) for kind, svc in (("exact", exact), ("int8", int8))}
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


def device_breakdown(service, batch, repeats: int = 3) -> dict:
    """Where one query batch's time goes: torch.profiler's CUDA events
    (kernels and copies) over ``repeats`` serial searches, summed by name,
    and the card's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    service.search(batch, TOP_K)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            service.search(batch, TOP_K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / repeats
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_batch": wall_us / repeats / 1e3,
        "device_ms_per_batch": busy_us / 1e3,
        "busy_share": busy_us * repeats / wall_us if busy_us else None,
        "top_ms": {name: us / 1e3 for name, us in top},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    card = card_line()
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
    serving = serving_phase([dense_table_lookup])
    serving["card"] = card
    print("serving " + json.dumps(serving), flush=True)

    notice = kernels["onehot_lookup"][0]
    record = {"kernels": [{
        "name": "onehot_lookup",
        "route": "cuda",
        "source": "jodalrob_twotower_torch/csrc/onehot_lookup.cu",
        "replaces": "jodalrob_twotower_tpu/ops/embedding_grad.py:358",
        "replaces_function": "ops/embedding_grad._lookup_kernel",
        "launches": serving["launches"]["dense_table_lookup"],
        "equal": all(c["equal"] for c in kernels["onehot_lookup"]),
        "max_abs_err": max(c["max_abs_err"] for c in kernels["onehot_lookup"]),
        "ms": notice["ms"], "plain_ms": notice["plain_ms"],
        "bound_ms": notice["bound_ms"], "bound_by": "bytes",
        "library_ms": notice["library_ms"],
        "kernel_us": notice["ms"] * 1e3, "library_us": notice["library_ms"] * 1e3,
        "bound_us": notice["bound_ms"] * 1e3,
        "cases": kernels["onehot_lookup"],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
