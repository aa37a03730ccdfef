"""K4, the row gather (one launch a tower a step): the least time its
launches need, from the distinct table rows each step's ids read, over
their card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, k4_row_gather


def read(s: dict):
    if "lookups" not in s:
        return None
    us = device_us(s, k4_row_gather.KERNELS)
    if not us:
        return None
    nbytes = sum(k4_row_gather.nbytes(s["batch"] * side["features"], u, side["dim"])
                 for side in s["lookups"].values() for u in side["unique_rows"])
    return 100.0 * peaks.bound_s(nbytes=nbytes) / (us / 1e6)
