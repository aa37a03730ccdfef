"""The text encoder's sort of (token, expert) pairs by expert: the least
time of its launches in the card-only traced pass (bytes over the memory
rate, every pair of every padded token) over the kernel's card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, moe_sort


def read(s: dict):
    m = s.get("encoder")
    if not m:
        return None
    us = device_us(s, moe_sort.KERNELS)
    if not us:
        return None
    launches = m["batches"] * len(m["pairs"])
    nbytes = launches * moe_sort.nbytes(m["batch"] * m["seq"] * m["top_k"], m["experts"])
    return 100.0 * peaks.bound_s(nbytes=nbytes) / (us / 1e6)
