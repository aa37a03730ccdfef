"""The text encoder's weighted combine: the least time of its launches in
the card-only traced pass (bytes over the memory rate; every padded token's
residual, shared and new rows, each routed pair's row) over the kernel's
card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, moe_combine


def read(s: dict):
    m = s.get("encoder")
    if not m:
        return None
    us = device_us(s, moe_combine.KERNELS)
    if not us:
        return None
    tokens = m["batches"] * m["batch"] * m["seq"]
    nbytes = sum(moe_combine.nbytes(tokens, p, m["top_k"], m["hidden"]) for p in m["pairs"])
    return 100.0 * peaks.bound_s(nbytes=nbytes) / (us / 1e6)
