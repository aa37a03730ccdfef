"""The whole step's share of the card's dense bf16 peak, in %: the model
FLOPs of the traced run's work (``benchmark/flops.py``) over the seconds the
driver gives for them. Where the cell's end-to-end metric is the card's
time a step (a host-paced training step), or where arrivals at a fixed
rate set the pace (so the FLOPs a second are the rate's), those are the
card's busy seconds, which fall as the kernels get faster; where the work
sets its own pace on the card (the large tables' training, a serving
backlog) they are the untraced pass's host-clock seconds, as the profiler
slows the host."""

from benchmark import peaks


def read(s: dict):
    if not s.get("model_flops") or not s.get("flops_s"):
        return None
    return 100.0 * s["model_flops"] / s["flops_s"] / peaks.BF16_FLOPS
