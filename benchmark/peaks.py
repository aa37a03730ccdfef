"""NVIDIA H100 SXM data-sheet peaks (dense, without sparsity), at the 700 W
power limit. Frozen here so that no program change moves a share's base."""

BF16_FLOPS = 989e12  # tensor cores, bf16 in, f32 accumulate
HBM_BYTES_PER_S = 3.35e12
# the special-function units' exponentials: 16 per clock and SM (CUDA C++
# Programming Guide, arithmetic throughput, compute capability 9.0), 132 SMs
# at the 1.98 GHz boost clock
EXP_PER_S = 132 * 16 * 1.98e9


def bound_s(flops: float = 0.0, nbytes: float = 0.0, exps: float = 0.0) -> float:
    """The least time the card could take: the larger of the operations over
    their peak (bf16 products; exponentials) and the bytes over the memory
    rate."""
    return max(flops / BF16_FLOPS, exps / EXP_PER_S, nbytes / HBM_BYTES_PER_S)
