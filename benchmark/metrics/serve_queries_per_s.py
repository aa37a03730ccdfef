"""Queries answered over the window's seconds (host clock). Open arrivals:
every batch due in the window, the window running until the last of them
is answered. A backlog: every batch sent while the window was open, over
the time to the last answer."""


def read(s: dict):
    return s.get("queries_per_s")
