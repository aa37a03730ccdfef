"""Faults planted in the program's text encoder (``models/text_encoder.py``),
for the tests and the calibration that show the title cell's comparison
catches them, and a command that reads the cell's numbers with one planted.
Each fault is a context manager that patches the program's module for the
length of the block.

- ``unscaled_routes``: the routing weights left unscaled (no
  ``routed_scaling_factor``), so each MoE layer's routed experts add 1/2.448
  of what they should;
- ``rope_base``: RoPE turned at base 10,000 in place of the config's
  ``rope_theta``.

    python3 -m benchmark.faults_kanana --workload serve.kanana2_title_int8 --seeds 1,2 \
        --fault unscaled_routes --seconds 3

prints, per seed, the numbers the comparison reads (``--fault none``: the
program as it stands), from ``--seconds`` of the cell's own traffic.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

import torch

from benchmark import spec
from benchmark.drivers import serve_title
from jodalrob_twotower_torch.models import text_encoder

FAULTS = ("unscaled_routes", "rope_base")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unscaled(inner):
    def forward(self, x):
        w, chosen = inner(self, x)
        return w / self.config.routed_scaling_factor, chosen

    return forward


def _base_10k(inner):
    def rope_tables(length, dim, theta, device):
        return inner(length, dim, 10_000.0, device)

    return rope_tables


@contextlib.contextmanager
def plant(name: str | None):
    if name is None:
        yield
    elif name == "unscaled_routes":
        with _patched(text_encoder._Router, "forward", _unscaled(text_encoder._Router.forward)):
            yield
    elif name == "rope_base":
        with _patched(text_encoder, "rope_tables", _base_10k(text_encoder.rope_tables)):
            yield
    else:
        raise ValueError(f"unknown encoder fault {name!r}; known: {FAULTS}")


def readings(cell: dict, seed: int, fault: str | None, seconds: float, device="cuda") -> dict:
    """The numbers the comparison reads after ``seconds`` of the cell's
    traffic, the fault planted through the run and the program's re-encoding
    of the check batches."""
    with plant(fault):
        run = serve_title.Run(cell, seed, device)
        run.window(seconds)
        run.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return run.judge()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--fault", required=True, choices=("none", *FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    print(torch.cuda.get_device_name(0), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = readings(cell, seed, None if args.fault == "none" else args.fault, args.seconds)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, **numbers,
                          "limits": cell["limits"], "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
