"""The program's own host spans, as the span readers take them: the roots of
one name in the program's in-memory record
(``jodalrob_twotower_torch/utils/profiling.span_record``) that began outside
any profiler session, set-up's warm calls and the traced run's untraced
pass, so that they time the host at its untraced speed."""

from __future__ import annotations

import statistics


def roots(s: dict, name: str) -> list[dict]:
    """The un-profiled roots named ``name``; none where the program keeps no
    spans, or where the traced run put no work on a card (on a host alone
    the work runs inside the spans, which then time it, not its dispatch)."""
    if not s.get("busy_s"):
        return []
    try:
        from jodalrob_twotower_torch.utils.profiling import span_record
    except ImportError:
        return []
    return [r for r in span_record() if r["name"] == name and not r["profiled"]]


def median_ms(rs: list[dict]) -> float | None:
    """The median of the roots' host milliseconds, None without a root."""
    return statistics.median((r["end_ns"] - r["start_ns"]) / 1e6 for r in rs) if rs else None
