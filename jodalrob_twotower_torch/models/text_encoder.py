"""A frozen text encoder for a tower's encoded text column: a decoder LM of
DeepSeek-V3's ``deepseek_v3`` layer equations (Kakao's
kanana-2-30b-a3b-instruct-2601, "kanana2"), run over a batch of token ids
in inference form, its last hidden states mean-pooled over each text's
tokens and L2-normalised, as ``etl/text.py``'s HF embedder pools a model's
output. The LM head is not held: an embedder reads the hidden states.

Per layer, with pre-norm residuals (RMSNorm, eps ``rms_norm_eps``):

* latent attention (MLA) with no query compression: q = W_q x, split per
  head into a nope part and a rope part; x -> W_kva -> [c | k_pe], c
  RMSNormed, then W_kvb gives each head's k_nope and v; interleaved RoPE
  (theta ``rope_theta``) on q_pe and on k_pe, which every head shares;
  causal softmax at scale 1 / sqrt(nope + rope) (torch's
  ``scaled_dot_product_attention`` over the 32 positions of a title), then
  W_o;
* the first ``first_k_dense_replace`` layers: a SwiGLU MLP of width
  ``intermediate_size``;
* the others: a router s = sigmoid(x W_g^T) in float32; the top k experts
  by s + b (b the correction bias, which only selects); weights s over the
  chosen ones, normalised to sum 1, times ``routed_scaling_factor``; out =
  sum_i w_i E_i(x) + shared(x), each expert a SwiGLU of width
  ``moe_intermediate_size`` and the shared one of ``n_shared_experts``
  times it. The router is a module (``mlp.gate``) whose forward returns the
  weights and the chosen experts, so a forward hook sees each layer's
  routing. The dispatch is ``ops/moe.py``'s sort, grouped products and
  combine; the token embedding is K4's row gather (``ops/embedding_lookup``).

Texts come right-padded: ids [B, L] and lengths [B]. Every dense product
runs over the B L rows (a padded row is computed and never read: causal
attention keeps it from every real token before it, and the pooling leaves
it out); the routed experts take only the real tokens' pairs.

The encoder computes in its weights' dtype (bfloat16 on the card; float32
in the CPU tests), the router, the norms' statistics, RoPE and the pooling
in float32. Weights are ``nn.Parameter`` leaves with requires_grad off, under
the module names of the HF checkpoint but for the experts, which are
stacked: ``mlp.experts.gate_up_proj`` [E, 2I, H] (each expert's gate rows,
then its up rows) and ``mlp.experts.down_proj`` [E, H, I]. The encoder is
frozen and holds no initialisation of its own: its weights are always
assigned (a checkpoint's, or drawn by the caller), and a fresh one's are
uninitialised memory.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from jodalrob_twotower_torch.ops import moe
from jodalrob_twotower_torch.ops.embedding_lookup import embedding_lookup_pallas

# keys of the published config that must hold these values: the equations
# above are written for them
REQUIRED = {"model_type": "deepseek_v3", "q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
            "n_group": 1, "topk_group": 1, "rope_scaling": None, "rope_interleave": True, "hidden_act": "silu",
            "attention_bias": False, "moe_layer_freq": 1}


@dataclasses.dataclass(frozen=True)
class KananaConfig:
    """The sizes the equations read, under the HF config's keys; the
    defaults are kanana-2-30b-a3b-instruct-2601's config.json."""

    vocab_size: int = 128_256
    hidden_size: int = 2048
    intermediate_size: int = 6144
    moe_intermediate_size: int = 768
    num_hidden_layers: int = 48
    first_k_dense_replace: int = 1
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 128
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.448
    norm_topk_prob: bool = True
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6

    @classmethod
    def from_dict(cls, d) -> "KananaConfig":
        """From an HF-style config dict (unknown keys are ignored); a key of
        :data:`REQUIRED` with another value raises."""
        d = dict(d)
        for key, want in REQUIRED.items():
            if key in d and d[key] != want:
                raise ValueError(f"the kanana2 encoder implements {key}={want!r}, the config has {d[key]!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


ENCODERS = {"kanana2": KananaConfig()}


def encoder_config(name: str, overrides=()) -> KananaConfig:
    """The named encoder's config with ``overrides`` ((key, value) pairs of
    an HF-style config, read as :meth:`KananaConfig.from_dict` reads them)."""
    if name not in ENCODERS:
        raise ValueError(f"unknown text encoder {name!r}; known: {sorted(ENCODERS)}")
    return KananaConfig.from_dict({**dataclasses.asdict(ENCODERS[name]), **dict(overrides)})


class _W(nn.Module):
    """One frozen weight, ``weight`` (the checkpoint's ``<name>.weight``)."""

    def __init__(self, *shape: int, dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


def _mlp_weights(module: nn.Module, hidden: int, width: int, dtype) -> None:
    module.gate_proj = _W(width, hidden, dtype=dtype)
    module.up_proj = _W(width, hidden, dtype=dtype)
    module.down_proj = _W(hidden, width, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, c: KananaConfig, dtype) -> None:
        super().__init__()
        h, nh = c.hidden_size, c.num_attention_heads
        self.q_proj = _W(nh * (c.qk_nope_head_dim + c.qk_rope_head_dim), h, dtype=dtype)
        self.kv_a_proj_with_mqa = _W(c.kv_lora_rank + c.qk_rope_head_dim, h, dtype=dtype)
        self.kv_a_layernorm = _W(c.kv_lora_rank, dtype=dtype)
        self.kv_b_proj = _W(nh * (c.qk_nope_head_dim + c.v_head_dim), c.kv_lora_rank, dtype=dtype)
        self.o_proj = _W(h, nh * c.v_head_dim, dtype=dtype)


class _Experts(nn.Module):
    def __init__(self, c: KananaConfig, dtype) -> None:
        super().__init__()
        e, h, i = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty((e, 2 * i, h), dtype=dtype), requires_grad=False)
        self.down_proj = nn.Parameter(torch.empty((e, h, i), dtype=dtype), requires_grad=False)


class _Router(nn.Module):
    def __init__(self, c: KananaConfig, dtype) -> None:
        super().__init__()
        self.config = c
        self.weight = nn.Parameter(torch.empty((c.n_routed_experts, c.hidden_size), dtype=dtype),
                                   requires_grad=False)
        # float32, as the checkpoint keeps it
        self.e_score_correction_bias = nn.Parameter(torch.empty(c.n_routed_experts), requires_grad=False)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weights float32 [T, k], chosen int64 [T, k]): the top k experts
        by sigmoid score plus the correction bias, weighted by their scores
        alone, normalised to sum 1 and scaled."""
        c = self.config
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        chosen = torch.topk(s + self.e_score_correction_bias.float(), c.num_experts_per_tok, dim=-1).indices
        w = s.gather(1, chosen)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * c.routed_scaling_factor, chosen


class _Layer(nn.Module):
    def __init__(self, c: KananaConfig, index: int, dtype) -> None:
        super().__init__()
        self.dense = index < c.first_k_dense_replace
        self.input_layernorm = _W(c.hidden_size, dtype=dtype)
        self.self_attn = _Attention(c, dtype)
        self.post_attention_layernorm = _W(c.hidden_size, dtype=dtype)
        self.mlp = nn.Module()
        if self.dense:
            _mlp_weights(self.mlp, c.hidden_size, c.intermediate_size, dtype)
        else:
            self.mlp.gate = _Router(c, dtype)
            self.mlp.experts = _Experts(c, dtype)
            self.mlp.shared_experts = nn.Module()
            _mlp_weights(self.mlp.shared_experts, c.hidden_size, c.n_shared_experts * c.moe_intermediate_size, dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) times the weight, the statistics in float32."""
    return F.rms_norm(x, (x.shape[-1],), weight, eps)


def rope_tables(length: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [length, dim / 2] at positions 0..length-1."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float() / dim))
    freqs = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return freqs.cos(), freqs.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved RoPE on x [B, L, heads, d]: pairs (x_2i, x_2i+1) turned by
    position x theta^(-2i/d), written de-interleaved (the rotated first
    members, then the second), as HF's ``apply_rotary_pos_emb_interleave``
    lays them out; in float32, cast back."""
    b, n, h, d = x.shape
    pairs = x.float().reshape(b, n, h, d // 2, 2)
    a, c = pairs[..., 0], pairs[..., 1]
    cos, sin = cos[None, :n, None, :], sin[None, :n, None, :]
    return torch.cat([a * cos - c * sin, c * cos + a * sin], dim=-1).to(x.dtype)


def latent_attention(q, kv, k_pe, cos, sin, batch: int, heads: int, nope: int, rope: int,
                     v_dim: int) -> torch.Tensor:
    """Causal MLA prefill over right-padded sequences: q [B L, heads (nope +
    rope)], kv [B L, heads (nope + v_dim)] (each head's k_nope, then its v),
    k_pe [B L, rope] shared by every head; RoPE on q_pe and k_pe; returns
    [B L, heads v_dim] in q's dtype. q is rotated in place. A padded
    position is computed like any other and never read: causal attention
    keeps it from every real position before it."""
    n = q.shape[0] // batch
    q = q.view(batch, n, heads, nope + rope)
    q[..., nope:] = apply_rope(q[..., nope:], cos, sin)
    kv = kv.view(batch, n, heads, nope + v_dim)
    k = torch.empty_like(q)
    k[..., :nope] = kv[..., :nope]
    k[..., nope:] = apply_rope(k_pe.reshape(batch, n, 1, rope), cos, sin)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), kv[..., nope:].transpose(1, 2),
                                       is_causal=True, scale=(nope + rope) ** -0.5)
    return o.transpose(1, 2).reshape(batch * n, heads * v_dim)


def _swiglu(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, module.gate_proj.weight)) * F.linear(x, module.up_proj.weight),
                    module.down_proj.weight)


class KananaEncoder(nn.Module):
    """``forward(ids [B, L] int, lengths [B] int) -> [B, hidden] float32``,
    each row a text's last hidden states (after the final norm) averaged
    over its ``lengths[b]`` tokens and L2-normalised."""

    def __init__(self, config: KananaConfig, dtype=torch.float32) -> None:
        super().__init__()
        self.config = c = config
        self.embed_tokens = _W(c.vocab_size, c.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(_Layer(c, i, dtype) for i in range(c.num_hidden_layers))
        self.norm = _W(c.hidden_size, dtype=dtype)

    def _attention(self, attn: _Attention, x: torch.Tensor, b: int, cos, sin) -> torch.Tensor:
        c = self.config
        lora = c.kv_lora_rank
        kva = F.linear(x, attn.kv_a_proj_with_mqa.weight)
        kv = F.linear(rms_norm(kva[:, :lora], attn.kv_a_layernorm.weight, c.rms_norm_eps), attn.kv_b_proj.weight)
        o = latent_attention(F.linear(x, attn.q_proj.weight), kv, kva[:, lora:], cos, sin, b, c.num_attention_heads,
                             c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim)
        return F.linear(o, attn.o_proj.weight)

    def _moe(self, mlp: nn.Module, x: torch.Tensor, resid: torch.Tensor, valid: torch.Tensor,
             tally: torch.Tensor) -> torch.Tensor:
        """resid + the MoE block's output on x (both [T, H])."""
        c = self.config
        e, k = c.n_routed_experts, c.num_experts_per_tok
        w, chosen = mlp.gate(x)
        ids = torch.where(valid[:, None], chosen, e).to(torch.int32).reshape(-1)
        perm, inv, counts, offsets = moe.sort_pairs(ids, e, tally)
        h = moe.grouped_gate_up(x, mlp.experts.gate_up_proj, perm, counts, offsets, k)
        y = moe.grouped_down(h, mlp.experts.down_proj, perm, counts, offsets, w.reshape(-1).contiguous())
        return moe.combine(y, inv, ids, _swiglu(mlp.shared_experts, x), resid, e)

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, n = ids.shape
        valid = (torch.arange(n, device=ids.device)[None, :] < lengths.reshape(b, 1)).reshape(-1)
        x = embedding_lookup_pallas(self.embed_tokens.weight, ids.reshape(-1))
        cos, sin = rope_tables(n, c.qk_rope_head_dim, c.rope_theta, ids.device)
        tally = moe.tally_buffer(ids.device, c.n_moe_layers, c.n_routed_experts) if c.n_moe_layers else None
        for i, layer in enumerate(self.layers):
            x = x + self._attention(layer.self_attn, rms_norm(x, layer.input_layernorm.weight, c.rms_norm_eps),
                                    b, cos, sin)
            h = rms_norm(x, layer.post_attention_layernorm.weight, c.rms_norm_eps)
            if layer.dense:
                x = x + _swiglu(layer.mlp, h)
            else:
                x = self._moe(layer.mlp, h, x, valid, tally[i - c.first_k_dense_replace])
        h = rms_norm(x, self.norm.weight, c.rms_norm_eps).float().view(b, n, -1)
        mask = valid.view(b, n, 1).float()
        pooled = (h * mask).sum(1) / mask.sum(1).clamp(min=1.0)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def build_text_encoder(spec, dtype) -> KananaEncoder:
    """The encoder an :class:`~jodalrob_twotower_torch.schema.EncodedTextSpec`
    names, its weights in ``dtype``."""
    config = encoder_config(spec.encoder, spec.config)
    if config.hidden_size != spec.embed_dim:
        raise ValueError(f"text column {spec.name!r}: embed_dim {spec.embed_dim} is not the "
                         f"{spec.encoder} encoder's hidden size {config.hidden_size}")
    return KananaEncoder(config, dtype)

