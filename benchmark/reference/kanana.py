"""The plain reference of the kanana2 text encoder (kakaocorp/kanana-2-30b-a3b-
instruct-2601, DeepSeek-V3's ``deepseek_v3`` layer equations), in float32
PyTorch with TF32 off, written from the published config and the model
type's equations. It imports nothing of the program: each layer's weights
are redrawn from the seed (``benchmark/gen_kanana.py``), used and freed, so
that the whole stack runs one layer at a time beside nothing else.

Per layer, pre-norm residuals with RMSNorm: latent attention with no query
compression (q = W_q x split into nope and rope parts; [c | k_pe] = W_kva
x; c RMSNormed; [k_nope | v] = W_kvb c per head; interleaved RoPE on q_pe
and the shared k_pe; a causal softmax at 1 / sqrt(nope + rope) written out
as a masked product, then W_o); a SwiGLU MLP in the first dense layers; in
the others a float32 sigmoid router, the top k experts by score plus the
correction bias, weights the chosen scores normalised to 1 times
``routed_scaling_factor``, the routed SwiGLU experts (one expert at a time
over the tokens that chose it) plus the shared one. The final norm, a mean
over each text's tokens, an L2 normalisation.

Departures from the published model, also listed under ``assumed`` in the
configuration file: no LM head (an embedder reads hidden states); no BOS
token (the traffic's ids stand for a title's tokens as they are); weights
drawn from the seed at assumed scales (``gen_kanana.py``), the correction
bias among them.

``prec="fp8"``: the control, every product's operands (each projection's
and each expert's weights, and the activations entering them) rounded to
float8 e4m3 with a per-tensor scale.

``routes``: each MoE layer's chosen experts given ([B L, k] a layer, in the
order of the MoE layers), so that the reference computes another run's
routing with its own arithmetic (the routing weights are still its own
scores at those experts): a comparison of the arithmetic alone, which a
near-tie between a token's k-th and (k+1)-th expert does not move.
``record``: a list that each MoE layer's chosen experts are appended to.
"""

from __future__ import annotations

import torch

from benchmark import gen_kanana
from benchmark.reference.model import fp8

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope(x, pos, theta):
    """x [B, L, heads, d], pairs (x_2i, x_2i+1) turned by pos theta^(-2i/d)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d))
    ang = (pos[:, None].double() * inv_freq[None, :]).float()[None, :, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * ang.cos() - b * ang.sin(), b * ang.cos() + a * ang.sin()], dim=-1)


def _swiglu(lin, p, x):
    return lin(torch.nn.functional.silu(lin(x, p + "gate_proj.weight")) * lin(x, p + "up_proj.weight"),
               p + "down_proj.weight")


def _layer(c: dict, w: dict, i: int, x, valid, prec: str, route=None, record=None):
    """x [B, L, H] -> the layer's output; ``valid`` [B, L] the real tokens;
    ``route`` the chosen experts [B L, k] to take in place of the top k;
    ``record`` a list the chosen experts are appended to."""
    q8 = fp8 if prec == "fp8" else (lambda t: t)

    def lin(t, name, weight=None):
        return q8(t) @ q8(w[name] if weight is None else weight).T

    b, n, h = x.shape
    eps, nh = c["rms_norm_eps"], c["num_attention_heads"]
    nope, rope, vd, lora = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    p = f"layers.{i}."
    a = _rms(x, w[p + "input_layernorm.weight"], eps)
    q = lin(a, p + "self_attn.q_proj.weight").view(b, n, nh, nope + rope)
    kva = lin(a, p + "self_attn.kv_a_proj_with_mqa.weight")
    ckv, k_pe = kva[..., :lora], kva[..., lora:]
    kv = lin(_rms(ckv, w[p + "self_attn.kv_a_layernorm.weight"], eps), p + "self_attn.kv_b_proj.weight")
    kv = kv.view(b, n, nh, nope + vd)
    pos = torch.arange(n, device=x.device)
    q_pe = _rope(q[..., nope:], pos, c["rope_theta"])
    k_pe = _rope(k_pe.view(b, n, 1, rope), pos, c["rope_theta"]).expand(b, n, nh, rope)
    qh = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
    kh = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2)
    vh = kv[..., nope:].transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2) * (nope + rope) ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1) @ vh
    x = x + lin(att.transpose(1, 2).reshape(b, n, nh * vd), p + "self_attn.o_proj.weight")
    a = _rms(x, w[p + "post_attention_layernorm.weight"], eps).reshape(b * n, h)
    if i < c["first_k_dense_replace"]:
        return x + _swiglu(lin, p + "mlp.", a).view(b, n, h)
    e, k, width = c["n_routed_experts"], c["num_experts_per_tok"], c["moe_intermediate_size"]
    s = torch.sigmoid(a @ w[p + "mlp.gate.weight"].T)
    if route is None:
        chosen = torch.topk(s + w[p + "mlp.gate.e_score_correction_bias"], k, dim=-1).indices
    else:
        chosen = route.to(device=x.device, dtype=torch.int64)
    if record is not None:
        record.append(chosen.cpu())
    weight = s.gather(1, chosen)
    if c["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * c["routed_scaling_factor"]
    out = _swiglu(lin, p + "mlp.shared_experts.", a)
    real = valid.reshape(-1)
    gu, down = w[p + "mlp.experts.gate_up_proj"], w[p + "mlp.experts.down_proj"]
    for ex in range(e):
        tok, slot = torch.nonzero((chosen == ex) & real[:, None], as_tuple=True)
        if tok.numel() == 0:
            continue
        xs = a[tok]
        y = lin(torch.nn.functional.silu(lin(xs, None, gu[ex, :width])) * lin(xs, None, gu[ex, width:]), None,
                down[ex])
        out.index_add_(0, tok, y * weight[tok, slot][:, None])
    return x + out.view(b, n, h)


@torch.no_grad()
def encode(c: dict, seed: int, ids: torch.Tensor, lengths: torch.Tensor, *, prec: str = "f32", routes=None,
           record: list | None = None) -> torch.Tensor:
    """[B, hidden] float32: each text's pooled, L2-normalised last hidden
    state; ``c`` the config file (HF keys), ``ids`` [B, L] right-padded,
    ``lengths`` [B]; ``routes`` and ``record`` as the module docstring says.
    Weights are redrawn on ``ids``'s device."""
    device = ids.device
    b, n = ids.shape
    valid = torch.arange(n, device=device)[None, :] < lengths.reshape(b, 1).to(device)
    table = gen_kanana.draw(c, seed, "embed", device)["embed_tokens.weight"]
    x = table[ids.long()]
    del table
    first_moe = c["first_k_dense_replace"]
    for i in range(c["num_hidden_layers"]):
        route = routes[i - first_moe] if routes is not None and i >= first_moe else None
        x = _layer(c, gen_kanana.draw(c, seed, i, device), i, x, valid, prec, route, record)
    x = _rms(x, gen_kanana.draw(c, seed, "norm", device)["norm.weight"], c["rms_norm_eps"])
    m = valid[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
