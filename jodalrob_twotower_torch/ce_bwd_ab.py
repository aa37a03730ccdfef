"""Times the CE backward (K11, and K10 past B = 8192) of several source
trees on one card, in turns, so two versions are compared inside one run.

Each tree is a checkout of the repository (its root holds ``chip_smoke.py``).
For every tree named, in the order given (name a tree twice to alternate:
``parent change change parent``), a separate Python process started in that
tree builds its kernels and runs its own ``chip_smoke.bwd_case`` at the
timed shapes: B = 8192 and 16384 at D = 128, 256 and 512 (each against its
plain version, two calls bit-equal, timed beside its bound and the library
call). With ``--training`` the process also runs that tree's training phase
and prints its device time per 16-step call. Every line a tree prints is
echoed prefixed with ``[tree i: path]``.

Run from the repository root on a machine with a CUDA card:
``python3 -m jodalrob_twotower_torch.ce_bwd_ab [--training] TREE [TREE ...]``.
Exits nonzero if a tree's run fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CASES = [(8192, 128), (8192, 256), (8192, 512), (16384, 128), (16384, 256), (16384, 512)]

_TREE_RUN = """
import json, sys, torch
import chip_smoke as cs
print(cs.bench.card_line(), flush=True)
f = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
for b, d in {cases}:
    label = "fused_ce_bwd" if b <= cs.CE_BATCH else "fused_ce_bwd_blocked"
    runs = cs.TIMED_RUNS if (b, d) == (cs.CE_BATCH, cs.CE_DIM) else cs.LARGE_TIMED_RUNS
    cs.bwd_case(f, b, runs=runs, label=label, d=d)
del f
if {training}:
    row, _ = cs.training_phase()
    print("training device_ms_per_call", json.dumps({{k: row[k] for k in ("device_ms_per_call", "ms_per_step",
          "examples_per_sec", "device_busy_share")}}), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="repository roots, in the order to run them")
    parser.add_argument("--training", action="store_true", help="also run each tree's training phase")
    args = parser.parse_args(argv)
    code = _TREE_RUN.format(cases=CASES, training=args.training)
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
