"""Contrastive training objectives (port of
``jodalrob_twotower_tpu/train/loss.py``).

* :func:`bidirectional_ce_loss` - in-batch negatives: S = N C^T / tau, labels
  on the diagonal, loss = 1/2 (CE(S) + CE(S^T)), optional label smoothing.
  With ``use_fused`` it runs the fused CE (ops/fused_logits.py), which never
  forms the [B, B] logits.
* :func:`cosine_embedding_loss` - the pairwise alternative.
"""

from __future__ import annotations

import torch

from jodalrob_twotower_torch.ops.fused_logits import fused_bidirectional_ce


def resolve_use_fused(loss_cfg, device: torch.device | str) -> bool:
    """``LossConfig.use_fused_logits`` ("auto" | bool) for a run on
    ``device``: "auto" is True on CUDA with the cross_entropy loss (the
    kernels' home, as the reference turns it on for its TPU) and False on the
    CPU, which keeps the materialized similarity matrix and the full metric
    surface."""
    v = loss_cfg.use_fused_logits
    if v == "auto":
        return torch.device(device).type == "cuda" and loss_cfg.loss_type == "cross_entropy"
    return bool(v)


def _smoothed_ce(logits: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Mean CE with diagonal labels over the rows of ``logits`` [B, B]."""
    b = logits.shape[0]
    logp = torch.log_softmax(logits, dim=-1)
    diag = torch.diagonal(logp)
    if label_smoothing > 0.0:
        off = label_smoothing / b
        # smoothed target: (1 - eps) on the diagonal + eps/B everywhere
        loss = -(1.0 - label_smoothing) * diag - off * logp.sum(-1)
    else:
        loss = -diag
    return loss.mean()


def bidirectional_ce_loss(
    notice_emb: torch.Tensor,
    company_emb: torch.Tensor,
    *,
    temperature: float = 1.0,
    label_smoothing: float = 0.0,
    use_fused: bool = False,
    normalized_inputs: bool = False,
):
    """Returns (loss, similarity [B, B] or None) for aligned positive pairs.
    ``normalized_inputs``: both embeddings are L2-normalized, which proves
    |logits| <= 1/temperature and lets the fused forward skip its max shift."""
    if use_fused:
        loss = fused_bidirectional_ce(
            notice_emb, company_emb, temperature, label_smoothing,
            (1.0 / temperature) if normalized_inputs else None,
        )
        return loss, None
    sim = (notice_emb.float() @ company_emb.float().T) / temperature
    loss = 0.5 * (_smoothed_ce(sim, label_smoothing) + _smoothed_ce(sim.T, label_smoothing))
    return loss, sim


def cosine_embedding_loss(
    notice_emb: torch.Tensor,
    company_emb: torch.Tensor,
    *,
    margin: float = 0.0,
):
    """Pairwise cosine loss with one shifted negative per positive: row i
    against company row i+1 (mod B). Returns (loss, similarity [B, B])."""
    pos = (notice_emb * company_emb).sum(-1)
    neg = (notice_emb * torch.roll(company_emb, shifts=-1, dims=0)).sum(-1)
    loss = (1.0 - pos).mean() + torch.clamp(neg - margin, min=0.0).mean()
    sim = notice_emb.float() @ company_emb.float().T
    return loss, sim


def compute_loss(
    loss_type: str,
    notice_emb: torch.Tensor,
    company_emb: torch.Tensor,
    *,
    temperature: float = 1.0,
    label_smoothing: float = 0.0,
    margin: float = 0.0,
    use_fused: bool = False,
    normalized_inputs: bool = False,
):
    if loss_type == "cross_entropy":
        return bidirectional_ce_loss(
            notice_emb,
            company_emb,
            temperature=temperature,
            label_smoothing=label_smoothing,
            use_fused=use_fused,
            normalized_inputs=normalized_inputs,
        )
    if loss_type == "cosine_embedding":
        return cosine_embedding_loss(notice_emb, company_emb, margin=margin)
    raise ValueError(f"unknown loss_type {loss_type!r}")
