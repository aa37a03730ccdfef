"""Headline training benchmark of the port: training examples/s at batch 8192
on one NVIDIA card.

The workload is the reference's ``bench.py``: a plain ``TrainConfig()`` (the
product default, whose "auto" knobs resolve on CUDA to the kernel path: the
one-hot lookup and table-gradient kernels, the fused CE forward and
backward, bf16 device stores) on ``reference_shaped_schema()``; synthetic
data of 100,000 notices, 100,000 companies and 400,000 pairs, stores and
pairs resident on the card; ``make_sampled_train_steps`` with 16 steps per
call, each step sampling its batch on the card. Weights start from a seeded
generator with the reference's ``model.init`` distributions
(``TwoTowerModel.init_flax``), as the reference bench's do.

Run: ``python -m jodalrob_twotower_torch.bench`` (needs a CUDA device).
Prints the card line (``nvidia-smi`` name and power limit), then one JSON
line with examples/s, ms/step and MFU against the H100's dense bf16 peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import reference_shaped_schema
from jodalrob_twotower_torch.train.train_step import (
    create_train_state,
    device_store,
    make_sampled_train_steps,
    resolve_store_dtype,
)
from jodalrob_twotower_torch.utils.flops import mfu, train_step_model_flops

BATCH_SIZE = 8192
N_INNER = 16
N_NOTICES = 100_000
N_COMPANIES = 100_000
N_PAIRS = 400_000
N_CLUSTERS = 256
TOTAL_STEPS = 1000  # the schedule's horizon, as the reference bench sets it


def flagship_config() -> TrainConfig:
    """The benched config IS the product default (guarded by
    tests/test_torch_bench_config.py)."""
    return TrainConfig()


@dataclasses.dataclass
class Workload:
    cfg: TrainConfig
    schema: object
    state: object
    steps: object  # make_sampled_train_steps(...)
    pairs: torch.Tensor
    notice_store: tuple
    company_store: tuple
    batch_size: int
    data_s: float
    dataset: object  # the SyntheticDataset the stores and pairs come from

    def call(self, sample_seed: int) -> dict:
        """One call of N_INNER steps; returns its metrics (on the card)."""
        self.state, metrics = self.steps(self.state, sample_seed, self.pairs, self.notice_store, self.company_store)
        return metrics


def build_workload(*, device=None, seed: int = 0, n_inner: int = N_INNER, batch_size: int = BATCH_SIZE) -> Workload:
    """Data, model, state and the sampled train steps of the headline bench,
    on ``device`` (None means the card)."""
    dev = resolve_device(device)
    cfg = flagship_config()
    schema = reference_shaped_schema()
    t0 = time.perf_counter()
    ds = make_synthetic_dataset(
        schema, n_notices=N_NOTICES, n_companies=N_COMPANIES, n_pairs=N_PAIRS, n_clusters=N_CLUSTERS, seed=0
    )
    store_dtype = resolve_store_dtype(cfg)
    notice_store = device_store(ds.notice_store, dtype=store_dtype, device=dev)
    company_store = device_store(ds.company_store, dtype=store_dtype, device=dev)
    pairs = torch.from_numpy(ds.pairs.astype(np.int64)).to(dev)
    data_s = time.perf_counter() - t0
    model = build_model(schema, cfg).init_flax(torch.Generator().manual_seed(seed))
    state, tx = create_train_state(model, cfg, seed, TOTAL_STEPS, device=dev)
    steps = make_sampled_train_steps(model, cfg, tx, n_inner, batch_size)
    return Workload(cfg, schema, state, steps, pairs, notice_store, company_store, batch_size, data_s, ds)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_calls(work: Workload, n_calls: int, *, first_seed: int = 1) -> dict:
    """Runs ``n_calls`` calls, each ended by fetching its losses to the
    host; returns examples/s, ms/step, MFU and the losses."""
    torch.cuda.synchronize()
    losses, ends = [], []
    start = time.perf_counter()
    for i in range(n_calls):
        losses.append(work.call(first_seed + i)["loss"].cpu().numpy())
        ends.append(time.perf_counter())
    elapsed = ends[-1] - start
    steps = sum(len(x) for x in losses)
    batch = work.batch_size
    eps = steps * batch / elapsed
    return {
        "examples_per_sec": eps,
        "ms_per_step": elapsed / steps * 1e3,
        "mfu": mfu(eps, work.schema, work.cfg, batch),
        "model_gflops_per_step": train_step_model_flops(work.schema, work.cfg, batch) / 1e9,
        "steps": steps,
        "call_ms": (np.diff([start] + ends) * 1e3).tolist(),
        "losses": [x.tolist() for x in losses],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=30, help="timed calls of 16 steps (default 30: 480 steps)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    work = build_workload()
    work.call(0)["loss"].cpu()  # warm-up: kernel builds, allocator
    out = timed_calls(work, args.calls)
    if not np.isfinite(np.asarray(out["losses"])).all():
        raise SystemExit("non-finite loss")
    print(json.dumps({
        "metric": "examples_per_sec_batch8192",
        "value": out["examples_per_sec"],
        "unit": "examples/s",
        "ms_per_step": out["ms_per_step"],
        "mfu": out["mfu"],
        "model_gflops_per_step": out["model_gflops_per_step"],
        "steps": out["steps"],
        "loss_first_call": float(np.mean(out["losses"][0])),
        "loss_last_call": float(np.mean(out["losses"][-1])),
        "device": torch.cuda.get_device_name(0),
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
