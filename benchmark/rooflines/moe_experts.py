"""The grouped expert products (``ops/moe.grouped_gate_up`` and
``grouped_down``, the CUDA kernel ``grouped_product<true>`` and
``grouped_product<false>`` in ``csrc/moe_dispatch.cu``): one launch of each
an MoE layer a batch."""

KERNELS = r"grouped_product<"


def cost(pairs: int, touched: int, hidden: int, inter: int) -> list[dict]:
    """Both launches of one layer: ``pairs`` routed (token, expert) pairs over
    ``touched`` experts (those with any). Gate/up: 4 H I a pair; each
    touched expert's [2I, H] bf16 read once, each pair's token row read and
    its h row written. Down: 2 H I a pair; each touched expert's [H, I],
    the h rows read and the y rows written, bf16."""
    return [{"flops": 4 * hidden * inter * pairs,
             "nbytes": touched * 2 * inter * hidden * 2 + pairs * (hidden + inter) * 2},
            {"flops": 2 * hidden * inter * pairs,
             "nbytes": touched * hidden * inter * 2 + pairs * (inter + hidden) * 2}]
