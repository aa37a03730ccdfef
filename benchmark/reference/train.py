"""The reference's first training steps: from the benchmark's weights and
data, the same sampled rows and dropout masks as the program's steps, the
loss, the gradients and the optimizer update, in ``prec`` arithmetic.

It returns what the comparison reads: each step's loss, each leaf's
gradient norm at the first step, and each leaf's change after the last.
"""

from __future__ import annotations

import torch

from benchmark.reference.model import Optimizer, batch_rows, dropout_masks, in_batch_ce, tower


def first_steps(weights: dict, data: dict, schema: dict, train_config: dict, *, sample_seed: int, state_seed: int,
                batch: int, total_steps: int, n_steps: int = 3, prec: str = "f32") -> dict:
    """``weights``: every state_dict leaf (float32, not modified); ``data``:
    the generator's stores and pairs. Runs in float32 with TF32 off, as
    nothing here asks for it."""
    model, loss_cfg = train_config["model"], train_config["loss"]
    if loss_cfg["loss_type"] != "cross_entropy" or loss_cfg["label_smoothing"]:
        raise ValueError("the reference follows the unsmoothed cross-entropy loss only")
    keys = [k for k in weights if not k.endswith(("running_mean", "running_var"))]
    params = {k: weights[k].detach().clone().float().requires_grad_(True) for k in keys}
    stats = {k: v.float() for k, v in weights.items() if k not in params}
    opt = Optimizer(params, train_config["optimizer"], total_steps)
    pairs = data["pairs"]
    device = pairs.device
    losses, grad_norms = [], {}
    for step in range(n_steps):
        rows = pairs.index_select(0, batch_rows(device, sample_seed, step, pairs.shape[0], batch))
        n_masks, c_masks = dropout_masks(device, state_seed, step, batch, model)
        w = {**params, **stats}
        embs = []
        for side, idx, masks in (("notice", rows[:, 0], n_masks), ("company", rows[:, 1], c_masks)):
            dense, cat = data[side]
            embs.append(tower(w, side, schema[side], model, dense.index_select(0, idx), cat.index_select(0, idx),
                              train=True, masks=masks, prec=prec))
        loss = in_batch_ce(*embs, loss_cfg["temperature"], prec)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if step == 0:
            grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.update(params, grads)
        del grads
    change = {k: float((params[k].detach() - weights[k].float()).double().norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
