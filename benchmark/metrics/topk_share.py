"""The card time of the kernels of torch's top-k (``at::native::mbtopk`` and
``sbtopk``, and the sort of each selection), over the card-only traced
pass's window, in %. The kernels are found by name: the profiler's pairing
of kernels with the host operators that launched them over-counts in torch
2.11 once the launch queue fills (206-358% of the window in a run above
capacity)."""

from benchmark.rooflines import device_us

TOPK = r"at::native::mbtopk::|at::native::sbtopk::|at::native::radixSortKVInPlace<"


def read(s: dict):
    us = device_us(s, TOPK)
    if not us or not s.get("window_s"):
        return None
    return 100.0 * us / 1e6 / s["window_s"]
