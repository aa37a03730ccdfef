"""Analytic model-FLOPs accounting for MFU (port of
``jodalrob_twotower_tpu/utils/flops.py``).

"Model FLOPs" are the algorithmically required operations of a train step:
the tower matmuls (forward plus the standard 2x for the backward) and the
[B, B] in-batch logits (one forward product and the two backward
contractions). Implementation FLOPs are excluded: the fused loss recomputes
S in its backward, and the table gradient is O(B K D) adds however it is
computed. MFU = model FLOP/s over the card's peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense bf16 tensor-core peak without sparsity (NVIDIA H100
# Tensor Core GPU data sheet), at the 700 W power limit.
H100_PEAK_BF16_FLOPS = 989e12


def tower_forward_flops_per_example(side, cfg) -> int:
    """Matmul FLOPs (2 m n per [m] -> [n] dense layer) of one tower forward,
    per example; ``side`` is a SideSchema, ``cfg`` a TrainConfig. Mirrors
    models/tower.py layer by layer."""
    m = cfg.model
    f = 0
    n_blocks = 0
    if side.num_numeric:
        f += 2 * side.num_numeric * m.dense_projection_dim
        n_blocks += 1
    for t in side.text:
        f += 2 * t.embed_dim * m.dense_projection_dim
        n_blocks += 1
    width = 0
    if n_blocks:
        proj_out = n_blocks * m.dense_projection_dim
        f += 2 * proj_out * m.tower_hidden_dims[0]
        width += m.tower_hidden_dims[0]
    width += side.num_categorical * m.categorical_embedding_dim
    for w in m.tower_hidden_dims[1:]:
        f += 2 * width * w
        width = w
    f += 2 * width * m.final_embedding_dim
    return f


def train_step_model_flops(schema, cfg, batch_size: int) -> int:
    """Model FLOPs of ONE train step at ``batch_size``: towers forward +
    backward = 3x the forward matmuls; logits 2 B^2 D forward and 2 B^2 D
    for each of dN = A C and dC = A^T N."""
    tower_fwd = tower_forward_flops_per_example(schema.notice, cfg) + tower_forward_flops_per_example(
        schema.company, cfg
    )
    per_example = 3 * tower_fwd + 6 * batch_size * cfg.model.final_embedding_dim
    return per_example * batch_size


def mfu(
    examples_per_sec: float,
    schema,
    cfg,
    batch_size: int,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
) -> float:
    """Model-FLOPs utilization: achieved model FLOP/s over ``peak_flops``."""
    flops_per_example = train_step_model_flops(schema, cfg, batch_size) / batch_size
    return examples_per_sec * flops_per_example / peak_flops
