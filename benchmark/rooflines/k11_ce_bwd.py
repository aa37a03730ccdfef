"""K11, the fused CE backward (``ops/fused_logits.fused_ce_bwd``,
``csrc/fused_ce_bwd.cu``): one launch a step."""

KERNELS = r"ce_bwd_wgmma|ce_bwd_chunked"


def cost(batch: int, dim: int) -> dict:
    """Products 6 B^2 D (S, A C, A^T N); two exponentials an entry; N, C in
    bf16 and both log-sum-exps read, dN and dC written in f32."""
    return {"flops": 6 * batch * batch * dim, "nbytes": 2 * batch * dim * 2 + 2 * batch * 4 + 2 * batch * dim * 4,
            "exps": 2 * batch * batch}
