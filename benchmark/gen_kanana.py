"""Weights of the kanana2 text encoder, drawn one layer at a time from the
seed alone, so that the program can fill its bfloat16 weights layer by
layer (no float32 copy of the whole model is ever held: it would be 122 GB)
and the reference can redraw any one layer in float32 after the program's
state is freed. ``gen.make_weights`` draws every leaf as one tensor and is
not used for the encoder.

A piece is the embedding (``"embed"``), a layer (its index) or the final
norm (``"norm"``); each has a generator of its own, seeded from (seed,
piece). Leaves are named as the program's encoder names them
(``models/text_encoder.py``; the experts stacked, [E, 2I, H] gate rows then
up rows, and [E, H, I]) and drawn in the order :func:`piece_shapes` lists
them. The scales are assumed (the published weights are not in the
repository): matrices N(0, 1/fan_in), but those that write into the
residual stream (each attention's W_o and each MLP's and expert's down
projection) N(0, 1/(2 L fan_in)), L the layers, as GPT-2's and Megatron's
scaled initialisation draws them, so that each layer adds a small part to
the residual as in a trained model and 48 random layers do not amplify a
rounding into a different text; the embedding N(0, 1), norm weights
1 + N(0, 0.1^2). The router's correction bias is zero, drawn from nothing: a
trained bias balances the experts' load over the training tokens, which
are not in the repository, so selection is left to the scores alone (a
random bias would load a few experts on purpose).
"""

from __future__ import annotations

import torch

from benchmark import spec

NORM_STD = 0.1
RESIDUAL_WRITERS = ("self_attn.o_proj.weight", "down_proj.weight", "experts.down_proj")


def _mlp(prefix: str, hidden: int, width: int) -> dict:
    return {f"{prefix}.gate_proj.weight": (width, hidden), f"{prefix}.up_proj.weight": (width, hidden),
            f"{prefix}.down_proj.weight": (hidden, width)}


def piece_shapes(c: dict, piece) -> dict[str, tuple[int, ...]]:
    """The leaves of one piece and their shapes; ``c`` the config file (HF keys)."""
    h = c["hidden_size"]
    if piece == "embed":
        return {"embed_tokens.weight": (c["vocab_size"], h)}
    if piece == "norm":
        return {"norm.weight": (h,)}
    i, nh = int(piece), c["num_attention_heads"]
    nope, rope, vd, lora = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    p = f"layers.{i}."
    out = {p + "input_layernorm.weight": (h,),
           p + "self_attn.q_proj.weight": (nh * (nope + rope), h),
           p + "self_attn.kv_a_proj_with_mqa.weight": (lora + rope, h),
           p + "self_attn.kv_a_layernorm.weight": (lora,),
           p + "self_attn.kv_b_proj.weight": (nh * (nope + vd), lora),
           p + "self_attn.o_proj.weight": (h, nh * vd),
           p + "post_attention_layernorm.weight": (h,)}
    if i < c["first_k_dense_replace"]:
        out.update(_mlp(p + "mlp", h, c["intermediate_size"]))
    else:
        e, w = c["n_routed_experts"], c["moe_intermediate_size"]
        out.update({p + "mlp.gate.weight": (e, h), p + "mlp.gate.e_score_correction_bias": (e,),
                    p + "mlp.experts.gate_up_proj": (e, 2 * w, h), p + "mlp.experts.down_proj": (e, h, w)})
        out.update(_mlp(p + "mlp.shared_experts", h, c["n_shared_experts"] * w))
    return out


def pieces(c: dict) -> list:
    return ["embed", *range(c["num_hidden_layers"]), "norm"]


@torch.no_grad()
def draw(c: dict, seed: int, piece, device) -> dict[str, torch.Tensor]:
    """One piece's leaves in float32 on ``device``; the same (seed, piece)
    gives the same tensors on one device."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(spec.derive(seed, f"kanana.{piece}"))
    out = {}
    for name, shape in piece_shapes(c, piece).items():
        if name.endswith("e_score_correction_bias"):
            out[name] = torch.zeros(shape, device=device)
            continue
        z = torch.randn(shape, generator=gen, device=device)
        if len(shape) == 1:
            out[name] = z.mul_(NORM_STD).add_(1.0)
        elif name == "embed_tokens.weight":
            out[name] = z
        elif name.endswith(RESIDUAL_WRITERS):
            out[name] = z.mul_((2 * c["num_hidden_layers"] * shape[-1]) ** -0.5)
        else:
            out[name] = z.mul_(shape[-1] ** -0.5)
    return out
