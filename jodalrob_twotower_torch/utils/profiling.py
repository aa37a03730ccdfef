"""Profiling and observability (port of
``jodalrob_twotower_tpu/utils/profiling.py``).

* :class:`span` and :func:`span_record`: the program's own host spans (the
  names in :data:`SPANS`), kept in memory always and put on the profiler's
  trace while a session is on (below).
* :class:`MetricsLogger`: a structured JSONL metrics stream, one row per
  :meth:`MetricsLogger.log` with the step, the seconds since the logger was
  made and the metric dict. Numbers, numpy scalars and 0-dim tensors are
  written as floats, as the reference writes its arrays.
* :func:`trace`: a ``torch.profiler`` context over the CPU and, where there
  is one, the card, that writes a Chrome trace into its directory.
* :func:`device_table` and :func:`device_breakdown`: where the card's time
  went in a profiled span (device time by kernel name, the busy share of the
  wall time), the one reader the profiler CLI and ``chip_smoke.py`` share.
* :func:`device_flops_estimate`: measured matmul throughput of the card
  attached, not its data sheet's.
* :func:`median_ms`: a kernel's time on the card, the median of launches
  each timed alone with CUDA events after the L2 cache is flushed (the
  studies and ``chip_smoke.py``); :func:`kernel_launches` and
  :func:`reset_kernel_launches`: each kernel wrapper's launch count in this
  process, read and zeroed (the mesh scripts' ranks report theirs).

Spans. A *root* is one training step (``train.step``, its id the global
step) or one request (``serve.search``, its id the service's request count;
``serve.copy``, the process's count of result copies); the other spans are
its children, opened inside it on the same thread. Each span stamps its
start and end with ``time.time_ns()``, the Unix clock the profiler stamps
its host events with, so an in-memory span can be placed on a trace. The
last :data:`RING` roots stay in a ring, each with its children's times and
whether a profiler session was on when it began. While a session is on, a
span also opens a function-scope range on the trace
(``torch._C._profiler._RecordFunctionFast``): a host event, which names the
card's idle gaps under it and, unlike ``record_function``'s user annotation,
puts no range on the card. With no session on that costs one attribute read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

SPANS = (
    "train.step",  # root: one step, its batch's draw and gather included (train/train_step._train_on_batch)
    "train.batch",  # the draw and the store gather (make_indexed_train_step)
    "train.forward",  # functional_call of the towers and the loss (loss_and_grads)
    "train.backward",  # torch.autograd.grad and any gradient sync (loss_and_grads)
    "train.update",  # the optimizer's update, whichever the config picks (_train_on_batch)
    "train.sparse_step",  # root: one sparse-table step, its draw and gather included (train/sparse_tables)
    "train.sparse_update",  # AdamW on the dense leaves and rowwise Adagrad on the touched rows (sparse_tables)
    "serve.search",  # root: one RetrievalService.search_device
    "serve.encode",  # the notice tower (search_device)
    "serve.text",  # the tower's frozen text encoder, inside serve.encode (models/tower.Tower._encoded)
    "serve.scan",  # the index's first pass (serving/index._scanned_topk)
    "serve.rescore",  # the exact second pass (serving/index._rescore_topk)
    "serve.copy",  # root: a HostCopy's page-locked buffers and enqueued copies
)
RING = 8192  # roots kept

_NAME, _PARENT, _START, _END, _INNER = range(5)  # a span's record: [name, parent, start ns, end ns, children's ns]
_roots: collections.deque = collections.deque(maxlen=RING)  # [id, profiled, record, children's records]


class _Open(threading.local):
    def __init__(self) -> None:
        self.stack: list[span] = []


_open = _Open()


class span:
    """``with span(name):`` a child of the innermost open span of this
    thread's root; ``with span(name, root=id):`` a root. A child opened
    with no root open (a step's forward called alone) is put on the trace
    but kept nowhere in memory."""

    __slots__ = ("name", "root", "_rec", "_entry", "_range")

    def __init__(self, name: str, root: int | None = None) -> None:
        self.name, self.root = name, root

    def __enter__(self) -> "span":
        stack = _open.stack
        profiled = _autograd_profiler._is_profiler_enabled
        if self.root is not None:
            self._rec = [self.name, None, 0, 0, 0]
            self._entry = [self.root, profiled, self._rec, []]
        elif stack and stack[-1]._entry is not None:
            parent = stack[-1]
            self._rec = [self.name, parent.name, 0, 0, 0]
            self._entry = parent._entry
            self._entry[3].append(self._rec)
        else:
            self._rec = self._entry = None
        stack.append(self)
        if self._rec is not None:
            self._rec[_START] = time.time_ns()
        if profiled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        else:
            self._range = None
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _open.stack
        stack.pop()
        rec = self._rec
        if rec is None:
            return
        rec[_END] = end = time.time_ns()
        if stack and stack[-1]._entry is self._entry:
            stack[-1]._rec[_INNER] += end - rec[_START]
        if self.root is not None:
            _roots.append(self._entry)


def span_record() -> list[dict]:
    """The ring of the last :data:`RING` roots, oldest first, as plain data:
    per root its ``name``, ``id``, ``profiled`` (a profiler session was on
    when it began), ``start_ns`` and ``end_ns`` (Unix ns), ``self_ns`` (its
    time outside its children) and ``children``, in the order they opened,
    each with its ``name``, ``parent``, ``root`` (the root's id),
    ``start_ns``, ``end_ns`` and ``self_ns``."""

    def times(rec) -> dict:
        return {"start_ns": rec[_START], "end_ns": rec[_END], "self_ns": rec[_END] - rec[_START] - rec[_INNER]}

    return [{"name": rec[_NAME], "id": rid, "profiled": profiled, **times(rec),
             "children": [{"name": c[_NAME], "parent": c[_PARENT], "root": rid, **times(c)} for c in children]}
            for rid, profiled, rec, children in list(_roots)]


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
    events (kernels, copies and sets) summed by name per call; the card's
    busy ms per call and busy share of the wall time (None without device
    events), both from the union of the events' intervals, so work
    overlapping on two streams counts once; and, with ``host_top``, the host
    operators with the most self CPU time (inflated by the profiler's own
    cost). The ranges that annotations (``record_function``) put on the
    card are left out, as they cover work, not do it."""
    by_name: dict[str, float] = {}
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / repeats
            intervals.append((e.time_range.start, e.time_range.end))
    busy_us = 0.0
    at = float("-inf")
    for a, b in sorted(intervals):
        busy_us += max(0.0, b - max(a, at))
        at = max(at, b)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms_per_call": wall_us / repeats / 1e3,
        "device_ms_per_call": busy_us / repeats / 1e3,
        "busy_share": busy_us / wall_us if busy_us else None,
        "device_events_per_call": len(intervals) / repeats,
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
    K6/K7, K11/K10, K8, K5/K9, and the index scan's top-k and int8 product)."""
    from jodalrob_twotower_torch.ops import chunk_topk as ct
    from jodalrob_twotower_torch.ops import embedding_grad as eg
    from jodalrob_twotower_torch.ops import embedding_lookup as el
    from jodalrob_twotower_torch.ops import fused_logits as fl
    from jodalrob_twotower_torch.ops import int8_scan as i8

    return (eg.dense_table_lookup, eg.dense_table_grad, eg.dense_table_grad_bmajor, el.embedding_lookup_pallas,
            fl.fused_lean_lse, fl.fused_ce_bwd, fl.same_tile_diag, fl.fused_stats_sweep, ct.chunk_topk,
            i8.int8_scan)


def kernel_launches() -> dict[str, int]:
    """Each CUDA kernel wrapper's launches so far in this process: the
    ``launches`` count a wrapper raises by one where it launches its kernel.
    All stay 0 on the CPU."""
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def reset_kernel_launches() -> None:
    """Sets every wrapper's ``launches`` count to 0."""
    for f in _kernel_wrappers():
        f.launches = 0
