"""K6 and K11, the fused CE forward and backward (one launch of each a
step): the least time their launches need over their card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, k6_ce_fwd, k11_ce_bwd


def read(s: dict):
    if "steps" not in s:
        return None
    us = device_us(s, k6_ce_fwd.KERNELS) + device_us(s, k11_ce_bwd.KERNELS)
    if not us:
        return None
    least = sum(peaks.bound_s(**m.cost(s["batch"], s["final_dim"])) for m in (k6_ce_fwd, k11_ce_bwd))
    return 100.0 * least * s["steps"] / (us / 1e6)
