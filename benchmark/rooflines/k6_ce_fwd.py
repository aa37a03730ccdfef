"""K6, the lean fused CE forward without the max shift
(``ops/fused_logits.fused_lean_lse``, ``csrc/fused_ce_fwd.cu`` and
``softmax_sweep.cuh``): one launch a step. A launch is the sweep kernel and
its merge (or the chunked kernel and its column pass)."""

KERNELS = r"sweep_wgmma<\d+, true, false>|lean_merge|lean_lse_chunked|chunked_col_lse"


def cost(batch: int, dim: int) -> dict:
    """Products 2 B^2 D; one exponential an entry; N and C read in bf16, the
    row and column log-sum-exps written in f32."""
    return {"flops": 2 * batch * batch * dim, "nbytes": 2 * batch * dim * 2 + 2 * batch * 4, "exps": batch * batch}
