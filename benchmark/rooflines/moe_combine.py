"""The weighted combine (``ops/moe.combine``, Triton kernel
``_combine_kernel``): one launch an MoE layer a batch."""

KERNELS = r"_combine_kernel"


def nbytes(tokens: int, routed_pairs: int, top_k: int, hidden: int) -> int:
    """Each token's k int32 ids and rows read, its residual and shared rows
    read and its new row written (bf16), each routed pair's y row read."""
    return tokens * (top_k * 8 + 3 * hidden * 2) + routed_pairs * hidden * 2
