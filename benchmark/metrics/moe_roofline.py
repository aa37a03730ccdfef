"""The grouped expert products of the text encoder's MoE layers: the least
time of their launches in the card-only traced pass (each layer's FLOPs at
the bf16 peak or its touched experts' weights and its rows at the memory
rate, whichever is larger, from the expert-load counter's pairs) over the
two kernels' card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, moe_experts


def read(s: dict):
    m = s.get("encoder")
    if not m:
        return None
    us = device_us(s, moe_experts.KERNELS)
    if not us:
        return None
    least = sum(peaks.bound_s(**launch) for p, t in zip(m["pairs"], m["touched"])
                for launch in moe_experts.cost(p, t, m["hidden"], m["inter"]))
    return 100.0 * least / (us / 1e6)
