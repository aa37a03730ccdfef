"""The pairs' counting sort by expert (``ops/moe.sort_pairs``, CUDA kernel
``sort_pairs_kernel`` in ``csrc/moe_dispatch.cu``, its counting launch and
its scatter launch): one sort an MoE layer a batch."""

KERNELS = r"sort_pairs_kernel"


def nbytes(pairs: int, experts: int) -> int:
    """Every pair's int32 expert id read once, its sorted row and its pair
    written (int32 each), each bucket's count and first row written."""
    return pairs * 4 * 3 + (experts + 1) * 4 * 2
