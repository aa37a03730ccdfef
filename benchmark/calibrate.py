"""Readings that set a cell's limits and its serving rate; run on the card,
one process for many seeds. Not part of a benchmark run.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --what program
    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --what control
    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --what fault:half_batch
    python3 -m benchmark.calibrate --workload <cell> --seeds 1 --what capacity --rates 8,10,12

``program`` and ``fault:<name>`` print, per seed, the numbers the
comparison reads for the program as it stands or with the fault planted
(``faults.py``): a training cell's from its check call, a serving cell's
from ``--seconds`` of its own traffic. ``control`` prints the control's
(the reference one precision step down, in the program's place).
``capacity`` serves 64 batches due at once (at most ``max_in_flight`` on
the card), then ``--seconds`` at each of ``--rates``, and prints the
completed queries/s and the latency quantiles.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

import numpy as np
import torch

from benchmark import faults, spec


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def readings(cell: dict, seed: int, what: str, seconds: float) -> dict:
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic_spec']['driver']}")
    if what == "control":
        if cell["traffic_spec"]["driver"] == "serve":
            t = cell["traffic_spec"]
            return driver.control(cell, seed, "cuda", t["check_batches"] * t["batch_size"])
        return driver.control(cell, seed, "cuda")
    fault = what.split(":", 1)[1] if what.startswith("fault:") else None
    with faults.plant(fault):
        run = driver.Run(cell, seed, "cuda")
        if cell["traffic_spec"]["driver"] == "serve":
            run.window(seconds)
    run.release()
    _free()
    return run.judge()


def capacity(cell: dict, seed: int, seconds: float, rates: list[float]) -> list[dict]:
    """First 64 batches due at once (the service's capacity, at most
    ``max_in_flight`` on the card), then ``seconds`` at each rate."""
    t = cell["traffic_spec"]
    run = importlib.import_module("benchmark.drivers.serve").Run(cell, seed, "cuda")
    out = []
    for rate, span in [(1000.0, 0.064)] + [(r, seconds) for r in rates]:
        run.traffic = {**t, "arrivals": "open", "rate_per_s": rate}
        r = run._serve(span)
        lat = np.asarray(r["latencies"]) * 1e3
        out.append({"rate_per_s": rate, "batches": len(lat), "queries_per_s": len(lat) * t["batch_size"] / r["end"],
                    "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                    "max_ms": float(lat.max())})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--what", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", default="")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(torch.cuda.get_device_name(0), flush=True)
    if args.what == "capacity":
        capacity(cell, seeds[0], args.seconds, [float(r) for r in args.rates.split(",") if r])
        return
    for seed in seeds:
        t0 = time.perf_counter()
        numbers = readings(cell, seed, args.what, args.seconds)
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed, **numbers,
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
