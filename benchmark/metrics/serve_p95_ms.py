"""The 95th percentile, over every batch due in the window, of the time from
its due time to its results in host numpy (host clock)."""


def read(s: dict):
    return s.get("p95_ms")
