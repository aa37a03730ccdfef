"""AdamW for the dense params + rowwise Adagrad for the embedding tables
(port of ``jodalrob_twotower_tpu/train/optimizer.py``), written out in
tensor code: torch has no rowwise Adagrad, and ``torch.optim.AdamW`` differs
from ``optax.adamw`` in where it applies the decay and the learning rate.

Per update, with the 1-indexed warmup schedule ``lr(count)`` shared by both
groups (count = number of earlier updates):

* dense leaves (every leaf whose name has no "embeddings" part, biases and
  BatchNorm scale/bias included), ``optax.adamw`` with b1 0.9, b2 0.999,
  eps 1e-8, eps_root 0:
  mu = 0.1 g + 0.9 mu; nu = 0.001 g^2 + 0.999 nu; u = mu_hat / (sqrt(nu_hat) + eps);
  p += -lr * (u + weight_decay * p). ``adam_moment_dtype="bfloat16"``
  stores mu (only) in bf16, after the update has used its f32 value.
* tables, rowwise Adagrad: acc [rows, 1] starts at ``adagrad_init_accumulator``;
  acc += mean_D(g^2); p += lr * (-g * rsqrt(acc + eps)).

``gradient_clip_norm`` scales every gradient by max_norm / global_norm when
the global norm reaches max_norm, before the split. On a mesh with
row-sharded tables the norm counts each rank's block of a sharded leaf once
(``parallel/mesh.global_sq_norm``), so it is one device's norm. Parameters and state are
updated in place (the port keeps one copy of each, where the reference's
optax returns new arrays).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def warmup_constant_schedule(base_lr: float, total_steps: int, warmup_ratio: float):
    """Linear warmup to base_lr over warmup_ratio * total_steps, then
    constant; 1-indexed, so the first update (count 0) has a nonzero rate.
    Evaluated in float32, as the reference's jnp schedule is."""
    warmup_steps = max(int(total_steps * warmup_ratio), 1)

    def schedule(count: int) -> float:
        frac = np.minimum((np.float32(count) + np.float32(1.0)) / np.float32(warmup_steps), np.float32(1.0))
        return float(np.float32(base_lr) * frac)

    return schedule


def is_embedding_table(name: str) -> bool:
    """A state_dict key names a table when one of its parts is "embeddings"."""
    return "embeddings" in name.split(".")


class Optimizer:
    """``build_optimizer``'s two-group transform over a dict of named params
    (the model's ``named_parameters`` keys)."""

    def __init__(self, cfg, total_steps: int) -> None:
        if cfg.embedding_optimizer not in ("rowwise_adagrad", "adamw"):
            raise ValueError(f"unknown embedding_optimizer {cfg.embedding_optimizer!r}")
        self.cfg = cfg
        self.schedule = warmup_constant_schedule(cfg.learning_rate, total_steps, cfg.warmup_ratio)
        emb_lr = cfg.embedding_learning_rate or cfg.learning_rate
        self.emb_schedule = warmup_constant_schedule(emb_lr, total_steps, cfg.warmup_ratio)
        self.mu_dtype = torch.bfloat16 if cfg.adam_moment_dtype == "bfloat16" else torch.float32

    def _adam_names(self, params: Mapping[str, torch.Tensor]) -> list[str]:
        if self.cfg.embedding_optimizer == "adamw":
            return list(params)
        return [k for k in params if not is_embedding_table(k)]

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        adam = self._adam_names(params)
        state = {
            "count": 0,
            "mu": {k: torch.zeros_like(params[k], dtype=self._mu_dtype(k)) for k in adam},
            "nu": {k: torch.zeros_like(params[k]) for k in adam},
            "acc": {
                k: torch.full((p.shape[0],) + (1,) * (p.dim() - 1), self.cfg.adagrad_init_accumulator,
                              dtype=p.dtype, device=p.device)
                for k, p in params.items() if k not in adam
            },
        }
        return state

    def _mu_dtype(self, name: str) -> torch.dtype:
        # the "adamw" table group keeps f32 moments, as optax.adamw(mu_dtype=None) does
        return torch.float32 if is_embedding_table(name) else self.mu_dtype

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor], state: dict, *,
               mesh=None, sharded=frozenset()) -> None:
        """One update of ``params`` and ``state``, in place. On a mesh,
        ``sharded`` names the row-sharded leaves (for the global norm)."""
        count = state["count"]
        if self.cfg.gradient_clip_norm:
            grads = clip_by_global_norm(grads, self.cfg.gradient_clip_norm, mesh=mesh, sharded=sharded)
        lr = self.schedule(count)
        emb_lr = self.emb_schedule(count)
        t = count + 1
        # bias corrections as the reference forms them: 1 - decay**count in f32
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(t))
        for k, mu_old in state["mu"].items():
            g, p = grads[k], params[k]
            table = is_embedding_table(k)
            wd = 0.0 if table else self.cfg.weight_decay
            # b1 * mu in mu's stored dtype, as jnp multiplies a weak-typed
            # scalar into a bf16 array; the sum is f32
            mu = (1 - _B1) * g + (torch.tensor(_B1, dtype=mu_old.dtype) * mu_old).float()
            nu = (1 - _B2) * (g * g) + _B2 * state["nu"][k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            if wd:
                u = u + wd * p
            p.add_(torch.tensor(-(emb_lr if table else lr), dtype=torch.float32) * u)
            mu_old.copy_(mu)  # cast to the stored dtype
            state["nu"][k].copy_(nu)
        for k, acc in state["acc"].items():
            g = grads[k]
            acc.add_((g * g).mean(dim=tuple(range(1, g.dim())), keepdim=True))
            step = (-1.0 * g) * torch.rsqrt(acc + self.cfg.adagrad_eps)
            params[k].add_(torch.tensor(emb_lr, dtype=torch.float32) * step)
        state["count"] = t


def build_optimizer(cfg, total_steps: int) -> Optimizer:
    """AdamW (dense) + rowwise Adagrad (tables) with the shared warmup schedule."""
    return Optimizer(cfg, total_steps)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float, *, mesh=None,
                        sharded=frozenset()) -> dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below max_norm, else
    (g / global_norm) * max_norm. On a mesh the leaves named in ``sharded``
    are the rank's blocks of row-sharded leaves, summed over the ranks
    once; every rank gets the same norm."""
    if sharded and mesh is not None:
        from jodalrob_twotower_torch.parallel.mesh import global_sq_norm

        norm = torch.sqrt(global_sq_norm(dict(grads), mesh, sharded=sharded))
    else:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for k, g in grads.items()}
