"""One module per hand-written kernel: the names its launches take in the
profiler's trace and the least operations and bytes a launch needs, copied
from the kernel checks of ``chip_smoke.py`` and frozen here. Bytes count
each input byte read once and each output byte written once, for what these
inputs need (the distinct table rows a batch reads, not every row). The
per-layer readers (``metrics/*_roofline.*.py``) divide the least time of
every launch in the traced window (``peaks.bound_s``) by those launches'
card time. ``device_us`` also serves readers that find kernels by name.
"""

from __future__ import annotations

import re


def device_us(summary: dict, pattern: str) -> float:
    """Card microseconds of the trace's kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(v for k, v in summary["device_us_by_name"].items() if rx.search(k))
