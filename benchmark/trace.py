"""The traced run: the same stretch of work three times, reduced to what the
per-layer readers and the ``breakdown`` need.

1. Untraced, on the host clock: the seconds the ``mfu`` readers divide by,
   since the profiler slows a host-bound loop.
2. Under ``torch.profiler`` with the card's activity only: busy time, the
   union of the intervals in which any kernel, copy or set ran on the card,
   so that work overlapping on two streams counts once (a sum of event
   durations, as ``utils/profiling.device_table`` takes it, counts it twice
   and can pass the window), and kernel time summed by kernel name.
3. Under the profiler with the host's activity too, which doubles the time
   of a host-bound step: only to name the idle gaps, each by the innermost
   host event running at its middle. Their seconds are this pass's.
"""

from __future__ import annotations

import bisect
import gc
import time

import torch

WINDOW = "benchmark.window"
TOP = 10
GAPS_NAMED = 50000  # the longest gaps are named; shorter ones still count as idle
LOOKBACK = 500  # host events searched backwards for one that holds a gap's middle


def traced(fn):
    """([fn's result in each pass], summary) of the three passes over ``fn()``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    plain, plain_s = _timed(fn)
    with profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]) as prof:
        dev, dev_s = _timed(fn)
    summary = _summarize_quietly(prof, dev_s)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            named, named_s = _timed(fn)
    summary["breakdown"]["idle_gaps"] = _summarize_quietly(prof, named_s)["breakdown"]["idle_gaps"]
    summary.update(plain_window_s=plain_s, named_window_s=named_s)
    return [plain, dev, named], summary


def card_busy(fn):
    """(fn(), seconds in which anything ran on the card during it): ``fn``
    under the profiler with the card's activity only, the union of its
    kernels', copies' and sets' intervals read from the profiler's raw
    events, as ``summarize`` takes it. Reading the raw events costs a small
    part of what building the event tree that ``summarize`` reads does, so a
    whole window can be traced call by call. On a host with no card: (fn(), 0)."""
    if not torch.cuda.is_available():
        return fn(), 0.0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, busy_ns(prof.profiler.kineto_results.events()) / 1e9


def busy_ns(events) -> int:
    """Nanoseconds of the union of the card's intervals among raw profiler
    events, leaving out ranges that annotations put on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = []
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            start = e.start_ns()
            spans.append((start, start + e.duration_ns()))
    return sum(b - a for a, b in _union(spans))


def _summarize_quietly(prof, window_s: float) -> dict:
    """``summarize`` with the garbage collector held off: the trace's
    millions of event objects would set off full collections again and
    again, a fifth of a traced training run's time."""
    gc.disable()
    try:
        return summarize(prof.events(), window_s)
    finally:
        gc.enable()


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def summarize(events, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    w0, w1 = (win[0].time_range.start, win[0].time_range.end) if win else (0.0, float("inf"))
    host = [e for e in events if e.device_type != cuda and e.name != WINDOW]
    dev, by_name = [], {}
    for e in events:
        if e.device_type != cuda or e.name == WINDOW:  # the window's own annotation spans it on the card too
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    merged = _union(dev)
    busy_us = sum(b - a for a, b in merged)
    if not win:
        w0, w1 = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    gaps = _gaps(merged, w0, w1)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "device_us_by_name": by_name,
        "breakdown": {"device_ops": [[n[:160], us / 1e6] for n, us in top_ops],
                      "idle_gaps": _name_gaps(gaps, host)},
    }


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(merged, w0: float, w1: float):
    gaps, at = [], w0
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at and w1 != float("inf"):
        gaps.append((at, w1))
    return gaps


def _name_gaps(gaps, host) -> list:
    """Idle seconds summed by the innermost host event holding each gap's
    middle, the ten largest."""
    host = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_name: dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (a + b) / 2
        name = "no host event"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - LOOKBACK), -1):
            if host[j].time_range.end >= mid:
                name = host[j].name
                break
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a) / 1e6
    rest = sum((b - a) for a, b in gaps) / 1e6 - sum(by_name.values())
    if rest > 0:
        by_name["shorter gaps"] = rest
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
