"""The share of the card-only traced pass's window in which nothing ran on
the card: one less the union of every kernel's, copy's and set's interval
over the window, in %."""


def read(s: dict):
    if not s.get("window_s") or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
