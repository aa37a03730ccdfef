"""Times a kernel of several source trees on one card, in turns, so two
versions are compared inside one run.

Each tree is a checkout of the repository (its root holds ``chip_smoke.py``).
For every tree named, in the order given (name a tree twice to alternate:
``parent change change parent``), a separate Python process started in that
tree builds its kernels and runs that tree's own checks and timings, so a
parent's code times the parent:
* ``--kernel ce_bwd`` (the default): the CE backward (K11, and K10 past
  B = 8192) through its ``chip_smoke.bwd_case`` at B = 8192 and 16384, D =
  128, 256 and 512 (each against its plain version, two calls bit-equal,
  timed beside its bound and the library call);
* ``--kernel ce_bwd_shard``: the CE backward (K11) at D = 128 on a row
  shard of N (its last m rows, at row offset B - m) against all of C, m
  from 1,024 to B, at B = 4096 and 8192 (each against its plain version,
  timed beside its bound, with its grid: the dn sweep's blocks of 128 rows
  each sweep all B columns, the dc sweep's blocks of 128 rows of C each
  sweep the m rows of N);
* ``--kernel ce_fwd``: the lean CE forward (K6, and K7 past B = 8192)
  through its ``chip_smoke.lean_case``, unshifted and shifted, at B = 8192
  and 16384, D = 128, 256 and 512, and at B = 32768, D = 128 (each against
  its plain version, timed beside its bound and the library call);
* ``--kernel table_grad``: the table gradient (K2, and K3) through its
  ``chip_smoke.table_grad_phase`` (its cases as it checks and times them),
  then its ``dense_table_grad`` and ``dense_table_grad_bmajor`` timed at a
  skewed batch and at R = 65,536 on inputs built here, the same in every
  tree (a parent's phase may not time those).
* ``--kernel stats``: K8 and the statistics sweep (K5, and K9 past
  B = 8192) through its ``chip_smoke.stats_case`` at B = 8192 (D = 128,
  256 and 512), 16384 and 32768 (D = 128), each against its plain version,
  two calls bit-equal, timed beside its bound and the library call;
* ``--kernel lookup``: the one-hot lookup (K1) through its
  ``chip_smoke.lookup_phase`` (the notice, serving, company and ragged
  cases, bit-exact and timed);
* ``--kernel row_gather``: the row gather (K4) on inputs built here, the
  same in every tree (BASELINE config 3's [10,000,384, 64] f32 table, ids
  uniform over each feature's 1.25M from numpy seed 0): through
  ``embedding_lookup_pallas`` at rows [8192, 8] in f32 and bf16, a ragged
  B=1000 batch (rows at -1 and past the table), rank 1's block [R/2, 64]
  of 2 with the 65,536 ids clamped into it and one id (the launch's floor);
  then the whole masked gather of that block through
  ``masked_shard_gather(block, ids, offset, use_pallas=True)``. Each
  bit-exact against its plain arithmetic, timed beside its bound and
  ``index_select`` on the clamped rows, and timed again after an L2 flush
  that reads (``ms_clean_l2``: the L2 then holds no dirty lines to write
  back, as after the usual flush, which writes).
With ``--training`` the process also runs that tree's training phase and
prints its device time per 16-step call; with ``--evaluation`` it also runs
the evaluation phase on the trained state and prints each eval path's
device time for one profiled batch. Every line a tree prints is
echoed prefixed with ``[tree i: path]``.

Run from the repository root on a machine with a CUDA card:
``python3 -m jodalrob_twotower_torch.ce_bwd_ab [--kernel K] [--training]
TREE [TREE ...]``. Exits nonzero if a tree's run fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CASES = [(8192, 128), (8192, 256), (8192, 512), (16384, 128), (16384, 256), (16384, 512)]
FWD_CASES = CASES + [(32768, 128)]

_CE_BWD_RUN = """
for b, d in {cases}:
    label = "fused_ce_bwd" if b <= cs.CE_BATCH else "fused_ce_bwd_blocked"
    runs = cs.TIMED_RUNS if (b, d) == (cs.CE_BATCH, cs.CE_DIM) else cs.LARGE_TIMED_RUNS
    cs.bwd_case(f, b, runs=runs, label=label, d=d)
"""

SHARD_CASES = [(8192, 8192), (4096, 8192), (2048, 8192), (1024, 8192), (4096, 4096), (2048, 4096)]

_CE_BWD_SHARD_RUN = """
from jodalrob_twotower_torch.ops import fused_logits as fl
d = cs.CE_DIM
for m, b in {cases}:
    n, c = cs.ce_inputs(b, d, "cuda")
    rl, cl = cs.fused_lean_lse_plain(n, c, nomax=True)
    off = b - m
    args = (n[off:], c, rl[off:], cl, 0.0, off)
    got, want = fl.fused_ce_bwd(*args), cs.fused_ce_bwd_plain(*args)
    rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    if rel > cs.CE_BWD_RTOL:
        raise SystemExit(f"fused_ce_bwd rows {{off}}..{{b}} of B={{b}} vs plain: {{rel}} > {{cs.CE_BWD_RTOL}}")
    nb, cb = n[off:].to(torch.bfloat16).contiguous(), c.to(torch.bfloat16).contiguous()
    row = {{"case": f"rows {{off}}..{{b}} of B={{b}} D={{d}}", "max_rel_err": rel,
           "dn_blocks": m // 128, "dn_tiles_per_block": b // 64, "dc_blocks": b // 128, "dc_tiles_per_block": m // 64,
           "ms": cs.median_ms(lambda: fl.fused_ce_bwd(nb, cb, rl[off:], cl, 0.0, off), f)}}
    row.update(cs.bound(6 * m * b * d, (m + b) * d * 2 + (m + b) * 4 + (m + b) * d * 4, exps=2 * m * b))
    print("ab ce_bwd_shard", json.dumps(row), flush=True)
"""

STATS_CASES = [(8192, 128), (8192, 256), (8192, 512), (16384, 128), (32768, 128)]

_STATS_RUN = """
for b, d in {cases}:
    runs = cs.TIMED_RUNS if (b, d) == (cs.CE_BATCH, cs.CE_DIM) else cs.LARGE_TIMED_RUNS
    cs.stats_case(f, b, runs, d=d)
"""

_LOOKUP_RUN = """
cs.lookup_phase(f)
"""

# config 3's table and the scaled_dense path's rows (chip_smoke.scaled_rows,
# written out: a parent's chip_smoke may differ)
_ROW_GATHER_RUN = """
import numpy as np
from jodalrob_twotower_torch.models.embedding import table_layout
from jodalrob_twotower_torch.ops import embedding_lookup as el
from jodalrob_twotower_torch.parallel.sharded_embedding import masked_shard_gather
offsets, total = table_layout((1_250_000,) * 8)
ids = np.random.default_rng(0).integers(0, 1_250_000, size=(8192, 8)) + offsets[None, :]
rows = torch.from_numpy(ids.astype(np.int32)).cuda()
table = torch.randn(total, 64, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
ragged = rows[:1000].clone()
ragged[::97, 0] = -1
ragged[5::101, 3] = total + 3
half = total // 2
block = table[half:]
flat = rows.reshape(-1)
in_range = flat.long() >= half
local = (flat.long() - half).clamp(0, half - 1)


class ReadFlush:  # fills the L2 with clean lines: a sum over the flush buffer reads it
    def zero_(self):
        f.sum()


def report(case, fn, want, library, read_rows, ids):
    got = fn()
    if not torch.equal(got, want):
        raise SystemExit(f"row_gather {{case}}: not bit-exact against its plain arithmetic")
    nbytes = ids.numel() * ids.element_size() + (int(torch.unique(read_rows).numel()) + ids.numel()) * 64 * got.element_size()
    row = {{"case": case, "ms": cs.median_ms(fn, f), "library_ms": cs.median_ms(library, f),
           "ms_clean_l2": cs.median_ms(fn, ReadFlush()), **cs.bound(0, nbytes)}}
    print("ab row_gather", json.dumps(row), flush=True)


for case, t, r in (("f32 [8192, 8]", table, rows), ("bf16 [8192, 8]", table.to(torch.bfloat16), rows),
                   ("ragged B=1000", table, ragged), ("rank 1 block, ids clamped in", block, local),
                   ("one id, the launch floor", table, rows[:1, :1])):
    safe = r.reshape(-1).long().clamp(0, t.shape[0] - 1)
    report(case, lambda t=t, r=r: el.embedding_lookup_pallas(t, r), t.index_select(0, safe).reshape(*r.shape, 64),
           lambda t=t, safe=safe: t.index_select(0, safe), safe, r)
report("rank 1 block, whole masked gather", lambda: masked_shard_gather(block, flat, half, use_pallas=True),
       block.index_select(0, local).masked_fill_(~in_range[:, None], 0), lambda: block.index_select(0, local),
       local[in_range], flat)
"""

_CE_FWD_RUN = """
for b, d in {cases}:
    label = "fused_ce_fwd" if b <= cs.CE_BATCH else "fused_ce_fwd_blocked"
    runs = cs.TIMED_RUNS if (b, d) == (cs.CE_BATCH, cs.CE_DIM) else cs.LARGE_TIMED_RUNS
    for nomax in (True, False):
        cs.lean_case(f, b, nomax, runs, label, d)
"""

# ids built with numpy from seed 0: every id of a notice feature on one row
# (values of scale 0.01), and 64 features of vocab 1,000 with ids uniform
_TABLE_GRAD_RUN = """
cs.table_grad_phase(f)
import numpy as np
from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.ops import embedding_grad as eg
gen = np.random.default_rng(0)
notice = cs.reference_shaped_schema().notice.vocab_sizes
wide = (1000,) * 64
for name, vocabs, ids, scale in (
        ("notice skewed", notice, np.broadcast_to(table_layout(notice)[0] + 7, (8192, len(notice))), 0.01),
        ("envelope", wide, gen.integers(0, 1000, size=(8192, 64)) + table_layout(wide)[0], 1.0)):
    rows = torch.from_numpy(ids.astype(np.int32)).cuda()
    g = torch.from_numpy(gen.normal(0.0, scale, size=(*ids.shape, 32)).astype(np.float32)).to("cuda", torch.bfloat16)
    tf = torch.from_numpy(tile_feature_map(vocabs)).cuda()
    row = {{"case": f"{{name}} B=8192 K={{ids.shape[1]}} R={{table_layout(vocabs)[1]}} D=32"}}
    for what, fn in (("table_grad", eg.dense_table_grad), ("table_grad_bmajor", eg.dense_table_grad_bmajor)):
        row[what + "_ms"] = cs.median_ms(lambda: fn(rows, g, tf), f)
    print("ab table_grad", json.dumps(row), flush=True)
"""

_TREE_RUN = """
import json, sys, torch
import chip_smoke as cs
print(cs.bench.card_line(), flush=True)
f = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
{kernel_run}
del f
if {training} or {evaluation}:
    row, work = cs.training_phase()
    print("training device_ms_per_call", json.dumps({{k: row[k] for k in ("device_ms_per_call", "ms_per_step",
          "examples_per_sec", "device_busy_share")}}), flush=True)
if {evaluation}:
    ev, _ = cs.evaluation_phase(work)
    print("evaluation device_ms_per_batch", json.dumps({{p: {{"device_ms": ev[p]["device_one_batch"]["device_ms_per_call"],
          "ms_per_batch": ev[p]["ms_per_batch"], "top_ms": ev[p]["device_one_batch"]["top_ms"]}}
          for p in ("eval", "eval_b16384")}}), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="repository roots, in the order to run them")
    parser.add_argument("--kernel", choices=("ce_bwd", "ce_bwd_shard", "ce_fwd", "table_grad", "stats", "lookup",
                                             "row_gather"), default="ce_bwd",
                        help="the kernel to time")
    parser.add_argument("--training", action="store_true", help="also run each tree's training phase")
    parser.add_argument("--evaluation", action="store_true",
                        help="also run each tree's training and evaluation phases (device ms per eval batch)")
    args = parser.parse_args(argv)
    kernel_run = {"ce_bwd": lambda: _CE_BWD_RUN.format(cases=CASES),
                  "ce_bwd_shard": lambda: _CE_BWD_SHARD_RUN.format(cases=SHARD_CASES), "ce_fwd": lambda: _CE_FWD_RUN.format(cases=FWD_CASES),
                  "table_grad": _TABLE_GRAD_RUN.format, "stats": lambda: _STATS_RUN.format(cases=STATS_CASES),
                  "lookup": lambda: _LOOKUP_RUN, "row_gather": _ROW_GATHER_RUN.format}[args.kernel]()
    code = _TREE_RUN.format(kernel_run=kernel_run, training=args.training, evaluation=args.evaluation)
    failed = 0
    for i, tree in enumerate(args.trees):
        root = Path(tree).resolve()
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"[tree {i}: {tree}] {line.rstrip()}", flush=True)
        if proc.wait():
            failed += 1
            print(f"[tree {i}: {tree}] exited {proc.returncode}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
