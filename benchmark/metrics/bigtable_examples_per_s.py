"""Examples trained in the window over the window's seconds (host clock),
the window being whole calls, each ended by fetching its losses."""


def read(s: dict):
    return s.get("examples_per_s")
