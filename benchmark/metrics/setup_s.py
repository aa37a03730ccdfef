"""Seconds from the process's start to the first timed step: imports, data
and weights made on the card, the program's set-up, the check call and the
warm-up, with every kernel build that the first run in a checkout pays."""


def read(s: dict):
    return s.get("setup_s")
