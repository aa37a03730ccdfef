"""Model FLOPs of the kanana2 title encoder and of a served batch through it,
frozen here so that a later change to the program cannot move the ``mfu``
base. Counted over real tokens (a padded position is not the model's
work): every product 2 m n; a token at position p attends over p + 1 keys
(2 h (qk + v) (p + 1)); the router, the k routed experts and the shared
expert in each MoE layer; norms, RoPE, softmax and the pooling count none.
"""

from __future__ import annotations

from benchmark import flops


def token_flops(c: dict, position: int) -> int:
    """One token at ``position`` (0-based) through every layer; ``c`` the
    config file (HF keys)."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd, lora = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    attn = (2 * h * (nh * (nope + rope) + lora + rope) + 2 * lora * nh * (nope + vd) + 2 * nh * vd * h
            + 2 * nh * (nope + rope + vd) * (position + 1))
    dense = 6 * h * c["intermediate_size"]
    width = c["moe_intermediate_size"]
    moe = 2 * h * c["n_routed_experts"] + (c["num_experts_per_tok"] + c["n_shared_experts"]) * 6 * h * width
    n_dense = c["first_k_dense_replace"]
    return c["num_hidden_layers"] * attn + n_dense * dense + (c["num_hidden_layers"] - n_dense) * moe


def title_flops(c: dict, length: int) -> int:
    return sum(token_flops(c, p) for p in range(length))


def reference_side(side: dict) -> dict:
    """The side as the reference tower reads it: each encoded text column a
    text block of its pooled width."""
    enc = {name: e["embed_dim"] for name, e in side.get("encoded_text", {}).items()}
    return {**side, "text": {**side["text"], **enc}}


def serve_batch_flops(config_spec: dict, lengths, corpus: int) -> int:
    """A batch of titles of ``lengths``: the encoder, the notice tower and
    the exact product against every corpus row."""
    model = config_spec["train_config"]["model"]
    table = [title_flops(config_spec, n) for n in range(max(lengths, default=0) + 1)]
    q = len(lengths)
    tower = flops.tower_forward_flops(reference_side(config_spec["schema"]["notice"]), model)
    return sum(table[n] for n in lengths) + q * tower + 2 * q * corpus * model["final_embedding_dim"]
