"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's data and weights on the card from ``--seed``,
builds the program's objects, runs the check call and warms up; then the
window runs for ``--seconds`` (``--trace 0``: the end-to-end metrics), or a
fixed traced stretch of the same work (``--trace 1``: the per-layer
metrics, read from the profiler's trace). After the window the peak memory
is read, the program's state freed, and the reference decides ``correct``.
The last lines of standard error give each compared number beside its
limit; the last line of standard output is the result, as JSON.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# every kernel cache at a fixed place inside the checkout, so that a cell's
# second run in it builds nothing (the port's own libraries go to
# jodalrob_twotower_torch/_build/, beside its sources)
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

FORBIDDEN = {"jax", "jaxlib", "flax", "jodalrob_twotower_tpu"}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of ``cell`` on ``device`` (the chip check is the caller's):
    the result's fields, with ``checks`` [[name, value, limit], ...]."""
    import torch

    from benchmark import judge, spec
    from benchmark import trace as trace_mod

    on_card = torch.device(device).type == "cuda"
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic_spec']['driver']}")
    run = driver.Run(cell, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - PROCESS_START
    with HostMeter() as host:
        s = run.traced_window(trace_mod.traced) if trace else run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = run.judge()
    correct, checks = judge.verdict(numbers, cell["limits"], s["failed"])
    s["setup_s"] = setup_s
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = spec.reader(m["name"])(s)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": s["attempted"], "failed": s["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = s["breakdown"]
    out["numbers"] = numbers
    out["window"] = {k: s[k] for k in ("call_ms", "latency_ms") if k in s}
    out["setup_phases_s"] = {"imports": setup_s - sum(run.phases.values()), **run.phases}
    out["host"] = host.readings
    out["checks"] = checks
    return out


class HostMeter:
    """What the host did around the window, to tell a slow host from slow
    work: the time of a fixed pure-Python loop before and after, this
    process's CPU seconds, and the seconds and full passes of Python's
    garbage collector. (The card machine's sandbox shows no steal time, CPU
    number or context switches in /proc.)"""

    PROBE = 200_000

    def __enter__(self):
        self.readings: dict = {"probe_ms_before": self._probe()}
        self.gc_s, self.gc_full, self._gc_t0 = 0.0, 0, 0.0
        gc.callbacks.append(self._on_gc)
        self.times, self.t0 = os.times(), time.perf_counter()
        return self

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_full += info["generation"] == 2

    def __exit__(self, *exc) -> None:
        wall, times = time.perf_counter() - self.t0, os.times()
        gc.callbacks.remove(self._on_gc)
        self.readings.update(wall_s=wall, cpu_s=(times.user - self.times.user) + (times.system - self.times.system),
                             gc_s=self.gc_s, gc_full=self.gc_full, probe_ms_after=self._probe())

    def _probe(self) -> float:
        t0 = time.perf_counter()
        x = 0
        for i in range(self.PROBE):
            x += i & 7
        return (time.perf_counter() - t0) * 1e3


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    # one process, one host thread: the host work here is dispatch, and a pool
    # of idle workers only competes with it for the machine's shared cores
    torch.set_num_threads(1)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: nothing the benchmark reaches may import JAX or its package",
              file=sys.stderr)
        return 3
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
