"""Profiling and observability (port of
``jodalrob_twotower_tpu/utils/profiling.py``).

* :class:`StepTimer`: step timing whose ``stop(fetch)`` waits for the
  fetched tensor's device before it reads the clock, since a CUDA call
  returns before the card has finished.
* :class:`MetricsLogger`: a structured JSONL metrics stream, one row per
  :meth:`MetricsLogger.log` with the step, the seconds since the logger was
  made and the metric dict. Numbers, numpy scalars and 0-dim tensors are
  written as floats, as the reference writes its arrays.
* :func:`trace`: a ``torch.profiler`` context over the CPU and, where there
  is one, the card, that writes a Chrome trace into its directory.
* :func:`device_table` and :func:`device_breakdown`: where the card's time
  went in a profiled span (device time by kernel name, the busy share of the
  wall time), the one reader the profiler CLI and ``chip_smoke.py`` share.
* :func:`device_flops_estimate` and :func:`utilization`: achieved over
  measured-peak matmul throughput, so a utilization is relative to the card
  attached, not to a data sheet.
* :func:`median_ms`: a kernel's time on the card, the median of launches
  each timed alone with CUDA events after the L2 cache is flushed (the
  studies and ``chip_smoke.py``); :func:`kernel_launches` and
  :func:`reset_kernel_launches`: each kernel wrapper's launch count in this
  process, read and zeroed (the mesh scripts' ranks report theirs).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch


def _first_tensor(tree) -> torch.Tensor | None:
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, Mapping) else tree if isinstance(tree, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class StepTimer:
    """Wall-clock step timer; ``stop(fetch)`` first waits for the device of
    ``fetch`` (a tensor, or a dict/list/tuple holding one)."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, fetch=None) -> float:
        t = _first_tensor(fetch) if fetch is not None else None
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.percentile(self.times, 50)) if self.times else float("nan")

    def summary(self, batch_size: int | None = None) -> dict:
        out = {"steps": len(self.times), "mean_ms": self.mean * 1e3, "p50_ms": self.p50 * 1e3}
        if batch_size and self.times:
            out["examples_per_sec"] = batch_size / self.mean
        return out


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")
        self._start = time.time()

    def log(self, step: int, metrics: Mapping[str, object], **extra) -> None:
        row = {
            "step": int(step),
            "time": round(time.time() - self._start, 3),
            **{k: (float(v) if isinstance(v, (int, float, np.floating)) or hasattr(v, "item") else v)
               for k, v in metrics.items()},
            **extra,
        }
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path: str | Path) -> list[dict]:
        with Path(path).open() as fh:
            return [json.loads(line) for line in fh if line.strip()]


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``torch.profiler`` over the block; yields the profiler and, on a
    clean exit, writes ``<log_dir>/trace.json`` (Chrome trace format, for
    Perfetto or chrome://tracing)."""
    from torch.profiler import profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def device_table(prof, wall_us: float, repeats: int = 1, top: int = 8, host_top: int = 0) -> dict:
    """Where the card's time went in a profiled span of ``repeats`` calls
    that took ``wall_us`` on the host clock (ended by a synchronize): device
    events (kernels and copies) summed by name per call, the busy share of
    the wall time (None without device events) and, with ``host_top``, the
    host operators with the most self CPU time (inflated by the profiler's
    own cost)."""
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


def device_breakdown(fn, repeats: int = 3, top: int = 8, host_top: int = 0) -> dict:
    """:func:`device_table` of ``repeats`` serial calls of ``fn`` (a query
    batch, a training call) after one warm-up call, on the card."""
    from torch.profiler import profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_table(prof, wall_us, repeats, top, host_top)


_PEAK_CACHE: dict[tuple[str, str, int], float] = {}


def device_flops_estimate(*, dtype: str = "bfloat16", n: int = 2048, device=None) -> float:
    """Measured matmul FLOP/s of ``device`` (None: the card if there is one,
    else the CPU) for an [n, n] x [n, n] product in ``dtype``, cached per
    device name. On the card: the median of 10 products timed with CUDA
    events after a warm-up; on the CPU: the host clock over 3. At the
    default n the card does not reach its data-sheet peak, so name the
    measured value as such."""
    dev = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    key = (name, dtype, n)
    if key in _PEAK_CACHE:
        return _PEAK_CACHE[key]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    a = torch.ones((n, n), dtype=dt, device=dev)
    b = torch.ones((n, n), dtype=dt, device=dev)
    a @ b  # warm-up
    if dev.type == "cuda":
        times = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            a @ b
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        seconds = float(np.median(times))
    else:
        t0 = time.perf_counter()
        for _ in range(3):
            a @ b
        seconds = (time.perf_counter() - t0) / 3
    peak = 2 * n**3 / seconds
    _PEAK_CACHE[key] = peak
    return peak


def utilization(step_time_s: float, flops_per_step: float, **peak_kwargs) -> float:
    """Achieved fraction of the measured peak."""
    return (flops_per_step / step_time_s) / device_flops_estimate(**peak_kwargs)


def median_ms(fn, flush: torch.Tensor, runs: int = 100) -> float:
    """Median over ``runs`` launches of ``fn``, each timed alone with CUDA
    events after ``flush`` (a card tensor larger than the 50 MB L2 cache) is
    zeroed, so that a bound that assumes device-memory traffic applies. The
    flush keeps the card busy long enough for the host to enqueue the events
    and the launch behind it, so no host time falls between them."""
    fn()  # warm-up
    pairs = []
    for _ in range(runs):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _kernel_wrappers() -> tuple:
    """Every CUDA kernel wrapper that counts its launches (K1, K2, K3, K4,
    K6/K7, K11/K10, K8, K5/K9)."""
    from jodalrob_twotower_torch.ops import embedding_grad as eg
    from jodalrob_twotower_torch.ops import embedding_lookup as el
    from jodalrob_twotower_torch.ops import fused_logits as fl

    return (eg.dense_table_lookup, eg.dense_table_grad, eg.dense_table_grad_bmajor, el.embedding_lookup_pallas,
            fl.fused_lean_lse, fl.fused_ce_bwd, fl.same_tile_diag, fl.fused_stats_sweep)


def kernel_launches() -> dict[str, int]:
    """Each CUDA kernel wrapper's launches so far in this process: the
    ``launches`` count a wrapper raises by one where it launches its kernel.
    All stay 0 on the CPU."""
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def reset_kernel_launches() -> None:
    """Sets every wrapper's ``launches`` count to 0."""
    for f in _kernel_wrappers():
        f.launches = 0
