"""The plain reference: the two towers, the in-batch loss, the optimizer and
the exact scan, in float32 PyTorch, written from the published description
of the model (SURVEY.md 2.2-2.3; flax Dense, BatchNorm and Dropout; optax
adamw and a rowwise Adagrad). It imports nothing of the program and takes
nothing the program made: weights and inputs come from the benchmark's
generator, and every derived table (the unified table's row offsets, the
batch rows, the dropout masks) is worked out again here.

A tower: each dense block (the numeric features, each text vector) is
projected by a learned layer and a ReLU; the projections, concatenated, go
through one more layer to the first hidden width; the categorical
embeddings are appended; each further hidden layer is Linear, ReLU,
BatchNorm (batch statistics with the biased variance in training, running
statistics otherwise, eps 1e-5) and, in training, dropout; a head layer and
an L2 normalisation end it. The loss is the bidirectional in-batch softmax
cross entropy over S = N C^T / tau.

``prec`` selects the arithmetic: "f32" (no TF32), or the controls one step
below the configuration's precision: "fp8" rounds every product's operands
to float8 e4m3 with a per-tensor scale (the gradient passes straight
through), "tf32" rounds the scan's operands to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_ALIGNMENT = 128  # every feature's block of the unified table starts at a multiple of 128 rows
FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; gradient straight through."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return (((bits + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32).view(torch.float32)


def row_offsets(vocab_sizes) -> torch.Tensor:
    starts, acc = [], 0
    for v in vocab_sizes:
        starts.append(acc)
        acc += -(-v // ROW_ALIGNMENT) * ROW_ALIGNMENT
    return torch.tensor(starts, dtype=torch.int64)


def tower(w: dict, side_name: str, side: dict, model: dict, dense, cat_ids, *, train: bool, masks=(),
          prec: str = "f32") -> torch.Tensor:
    """[B, final] float32, L2-normalised. ``masks``: one uniform draw [B, width]
    per dropout layer, in layer order (training only)."""
    p = f"{side_name}_tower."
    q = fp8 if prec == "fp8" else (lambda t: t)

    def lin(name, x):
        return q(x) @ q(w[f"{p}{name}.weight"]).T + w[f"{p}{name}.bias"]

    dense = dense.float()
    blocks, start = [], 0
    if side["num_numeric"]:
        blocks.append(("proj_numeric", 0, side["num_numeric"]))
        start = side["num_numeric"]
    for name, width in side["text"].items():
        blocks.append((f"proj_{name}", start, width))
        start += width
    parts = []
    if blocks:
        projected = [torch.relu(lin(name, dense[:, a : a + n])) for name, a, n in blocks]
        parts.append(lin("dense_projection", torch.cat(projected, dim=1)))
    if side["vocab_sizes"]:
        vmax = torch.tensor(side["vocab_sizes"], device=cat_ids.device) - 1
        rows = torch.minimum(cat_ids.long().clamp(min=0), vmax) + row_offsets(side["vocab_sizes"]).to(cat_ids.device)
        parts.append(w[f"{p}embeddings.table"][rows].reshape(rows.shape[0], -1))
    x = torch.cat(parts, dim=1)
    keep = 1.0 - model["dropout_rate"]
    for i in range(len(model["tower_hidden_dims"]) - 1):
        x = torch.relu(lin(f"mlp_{i}", x))
        if model["use_batch_norm"]:
            bn = f"{p}bn_{i}."
            if train:
                mean, var = x.mean(0), x.var(0, unbiased=False)
            else:
                mean, var = w[bn + "running_mean"], w[bn + "running_var"]
            x = (x - mean) * torch.rsqrt(var + 1e-5) * w[bn + "weight"] + w[bn + "bias"]
        if train and model["dropout_rate"] > 0:
            x = torch.where(masks[i] < keep, x / keep, torch.zeros((), device=x.device))
    x = lin("head", x)
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def in_batch_ce(n: torch.Tensor, c: torch.Tensor, temperature: float, prec: str = "f32") -> torch.Tensor:
    """1/2 (CE(S) + CE(S^T)) with the diagonal as labels, S = N C^T / tau."""
    q = fp8 if prec == "fp8" else (lambda t: t)
    s = (q(n) @ q(c).T) / temperature
    labels = torch.arange(s.shape[0], device=s.device)
    return 0.5 * (torch.nn.functional.cross_entropy(s, labels) + torch.nn.functional.cross_entropy(s.T, labels))


def step_generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    """The program's documented rule for a step's random draws
    (``train/train_step.step_generator``): a generator seeded from
    (seed, stream, step) alone. Stream 0 gives the dropout masks, stream 1
    the sampled batch rows. Worked out again here so that the reference
    draws the same rows and masks from the seeds the benchmark handed out."""
    words = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, stream, int(step)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def batch_rows(device, sample_seed: int, step: int, n_pairs: int, batch: int) -> torch.Tensor:
    return torch.randint(0, n_pairs, (batch,), generator=step_generator(device, sample_seed, step, 1), device=device)


def dropout_masks(device, seed: int, step: int, batch: int, model: dict) -> tuple[list, list]:
    """Uniform draws for the notice tower's dropout layers, then the company
    tower's, in the order the towers run."""
    if model["dropout_rate"] <= 0:
        return [], []
    gen = step_generator(device, seed, step, 0)
    widths = model["tower_hidden_dims"][1:]
    draw = [[torch.rand((batch, w), generator=gen, device=device) for w in widths] for _ in range(2)]
    return draw[0], draw[1]


def is_table(key: str) -> bool:
    return key.endswith("embeddings.table")


def lr_at(base: float, count: int, total_steps: int, warmup_ratio: float) -> float:
    """Linear warm-up over warmup_ratio of the horizon, then constant; the
    first update (count 0) has rate base / warmup_steps."""
    warm = max(int(total_steps * warmup_ratio), 1)
    return base * min((count + 1) / warm, 1.0)


class Optimizer:
    """optax adamw (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) on
    the dense leaves; rowwise Adagrad on the tables: acc += mean_D(g^2),
    p -= lr g / sqrt(acc + eps)."""

    def __init__(self, params: dict, opt: dict, total_steps: int) -> None:
        self.opt, self.total = opt, total_steps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items() if not is_table(k)}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items() if not is_table(k)}
        self.acc = {k: torch.full((v.shape[0], 1), opt["adagrad_init_accumulator"], device=v.device)
                    for k, v in params.items() if is_table(k)}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        o = self.opt
        lr = lr_at(o["learning_rate"], self.count, self.total, o["warmup_ratio"])
        t = self.count + 1
        for k, g in grads.items():
            p = params[k]
            if is_table(k):
                self.acc[k] += (g * g).mean(dim=1, keepdim=True)
                p -= lr * g * torch.rsqrt(self.acc[k] + o["adagrad_eps"])
                continue
            self.mu[k].mul_(0.9).add_(0.1 * g)
            self.nu[k].mul_(0.999).add_(0.001 * g * g)
            u = (self.mu[k] / (1 - 0.9**t)) / (torch.sqrt(self.nu[k] / (1 - 0.999**t)) + 1e-8)
            p -= lr * (u + o["weight_decay"] * p)
        self.count = t
