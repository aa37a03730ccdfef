"""Component profiler for the sampled train step of the PyTorch port,
``python -m jodalrob_twotower_torch.profile_step [variant ...] [--trace]``
(port of ``scripts/profile_step.py``, one device).

* Variant timing (the default) times config-toggled variants and ablations
  of the step, so each component's cost comes from a measured difference:
  ``full`` (the production ``make_sampled_train_steps`` at ``TrainConfig()``),
  ``no_opt`` (the update replaced by p - 1e-9 g), ``fwd_only`` (forward and
  loss), ``gather_only`` (sampling and the batch gather), ``sample_only``
  (sampling), and ``full`` with one config knob toggled. Every variant
  returns params updated from what it computed, so no work is skipped; the
  lines at the end attribute the step's time to the optimizer, the
  backward, the forward and loss, the gather and the sampling.
* ``--trace`` runs 3 dispatches of ``full`` under ``torch.profiler`` and
  prints the device time of each kernel and the card's busy share of the
  traced span (``utils/profiling.device_table``).

A dispatch is one call of ``N_INNER`` steps at batch ``B``; a variant runs one
warm-up dispatch, then ``N_DISPATCH`` timed ones, and fetches one loss at the
end. ``threefry_dropout`` stays in the list for the reference's sake: the port
draws every dropout mask from one ``torch.Generator`` per step whatever
``dropout_rng_impl`` says, so it times the same step as ``full``. Runs on the
card; ``--force-cpu`` asks for the CPU (use ``--synthetic-scale tiny`` and a
small ``--batch-size`` there).
"""

from __future__ import annotations

import argparse
import copy
import sys
import tempfile
import time

import torch

from jodalrob_twotower_torch.config import LossConfig, ModelConfig, OptimizerConfig, TrainConfig
from jodalrob_twotower_torch.data.types import PairBatch, default_tower_gather
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.train.train_step import (
    DROPOUT_STREAM,
    SAMPLE_STREAM,
    _forward_loss,
    create_train_state,
    device_store,
    loss_and_grads,
    make_sampled_train_steps,
    resolve_store_dtype,
    step_generator,
)
from jodalrob_twotower_torch.utils.profiling import device_table, trace

B = 8192
N_INNER = 16
N_DISPATCH = 20
TOTAL_STEPS = 1000  # the schedule's horizon, as the bench sets it

VARIANTS = [
    "full",            # headline config
    "no_opt",          # - optimizer update
    "fwd_only",        # forward + loss only
    "gather_only",     # sample + batch gather only
    "sample_only",     # randint sampling only
    "no_dropout",      # full, dropout_rate=0
    "threefry_dropout",  # full, dropout_rng_impl="threefry": the same step as full in the port
    "no_bn",           # full, use_batch_norm=False
    "xla_loss",        # full, use_fused_logits=False (the materialized loss: no K6, K11)
    "scatter_grad",    # full, embedding_grad=scatter (gather forward, scatter backward: no K1, K2)
    "bf16_mu",         # full, AdamW first moment stored bf16
    "onehot_lookup",   # full, embedding_lookup=onehot (what "auto" takes on the card)
    "gather_lookup",   # full, embedding_lookup=gather (gather forward, K2 backward: no K1)
]
ABLATIONS = ("no_opt", "fwd_only", "gather_only", "sample_only")

_MODEL_TOGGLES = {"no_dropout": {"dropout_rate": 0.0},
                  "threefry_dropout": {"dropout_rng_impl": "threefry"},
                  "no_bn": {"use_batch_norm": False},
                  "scatter_grad": {"embedding_grad": "scatter"},
                  "onehot_lookup": {"embedding_lookup": "onehot"},
                  "gather_lookup": {"embedding_lookup": "gather"}}
_LOSS_TOGGLES = {"xla_loss": {"use_fused_logits": False}}
_OPT_TOGGLES = {"bf16_mu": {"adam_moment_dtype": "bfloat16"}}

# (component, variant, the variant it is measured against)
ATTRIBUTION = (("optimizer", "full", "no_opt"), ("backward", "no_opt", "fwd_only"),
               ("forward and loss", "fwd_only", "gather_only"), ("gather", "gather_only", "sample_only"),
               ("sampling and the loop", "sample_only", None))


def build(model_kw=None, loss_kw=None, opt_kw=None) -> TrainConfig:
    """``TrainConfig()`` (the bench's config: on the card its "auto" knobs
    resolve to the kernel path) with the given fields changed."""
    return TrainConfig(model=ModelConfig(**(model_kw or {})), loss=LossConfig(**(loss_kw or {})),
                       optimizer=OptimizerConfig(**(opt_kw or {})))


def setup_data(device, *, scale: str = "bench", seed: int = 0):
    """(schema, notice store, company store, pairs) on ``device``: the
    synthetic dataset at ``scale`` (bench: the headline bench's), stores at
    the default config's dtype. Built once for every variant."""
    from jodalrob_twotower_torch.train.cli import synthetic_data

    schema, notice_store, company_store, pairs = synthetic_data(scale, seed)
    dtype = resolve_store_dtype(build())
    return (schema, device_store(notice_store, dtype=dtype, device=device),
            device_store(company_store, dtype=dtype, device=device),
            torch.from_numpy(pairs.astype("int64")).to(device))


def setup_state(cfg: TrainConfig, schema, device, seed: int = 0):
    """(model, train state, optimizer) from the reference's init
    distributions, seeded."""
    model = build_model(schema, cfg).init_flax(torch.Generator().manual_seed(seed))
    state, tx = create_train_state(model, cfg, seed, TOTAL_STEPS, device=device)
    return model, state, tx


def make_full_step(model, cfg, tx, n_inner: int = N_INNER, batch: int = B):
    """The production sampled multi-step (``make_sampled_train_steps``, what
    the bench and the trainer run), returning (state, losses [n_inner])."""
    steps = make_sampled_train_steps(model, cfg, tx, n_inner, batch)

    def fn(state, seed, pairs, notice_store, company_store):
        state, metrics = steps(state, seed, pairs, notice_store, company_store)
        return state, metrics["loss"]

    return fn


def _nudge(state, delta: torch.Tensor) -> None:
    """Every param moved by ``delta``: the variant's output feeds the next
    step, so none of its work can be left out."""
    with torch.no_grad():
        for p in state.params.values():
            p.add_(delta)


def make_variant(model, cfg, tx, mode: str, n_inner: int = N_INNER, batch: int = B):
    """An ablation of the step body (one of ``ABLATIONS``), sampled as the
    production step samples: ``fn(state, seed, pairs, notice_store,
    company_store) -> (state, probes [n_inner])``."""
    if mode not in ABLATIONS:
        raise ValueError(f"unknown ablation {mode!r}; choose from {ABLATIONS}")

    def fn(state, seed, pairs, notice_store, company_store):
        out = []
        for _ in range(n_inner):
            gen = step_generator(pairs.device, seed, state.step, SAMPLE_STREAM)
            rows = torch.randint(0, pairs.shape[0], (batch,), generator=gen, device=pairs.device)
            if mode == "sample_only":
                probe = rows.sum().float() * 1e-20
                _nudge(state, probe)
                state.step += 1
                out.append(probe)
                continue
            pair_idx = pairs.index_select(0, rows)
            b = PairBatch(notice=default_tower_gather(notice_store, pair_idx[:, 0]),
                          company=default_tower_gather(company_store, pair_idx[:, 1]))
            if mode == "gather_only":
                probe = (b.notice.dense.float().sum() + b.company.dense.float().sum()
                         + b.notice.cat_ids.sum() + b.company.cat_ids.sum()).float()
                _nudge(state, probe * 1e-20)
                state.step += 1
                out.append(probe)
                continue
            if mode == "fwd_only":
                drop = (step_generator(state.device, state.seed, state.step, DROPOUT_STREAM)
                        if cfg.model.dropout_rate > 0 else None)
                with torch.no_grad():
                    loss = _forward_loss(model, cfg, state.state_dict, b, drop, train=True)[0]
                _nudge(state, loss * 1e-20)
            else:  # no_opt
                loss, _, grads = loss_and_grads(model, cfg, state, b)
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.sub_(1e-9 * grads[k])
            state.step += 1
            out.append(loss)
        return state, torch.stack(out)

    return fn


def prepare(name: str, schema, device, base=None, *, n_inner: int = N_INNER, batch: int = B):
    """(fn, fresh state) of variant ``name``. ``base`` is the default
    config's (model, state, tx), shared by ``full`` and the ablations; each
    variant gets its own copy of the state."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")
    if name == "full" or name in ABLATIONS:
        model, state, tx = base or setup_state(build(), schema, device)
        cfg = build()
        fn = make_full_step(model, cfg, tx, n_inner, batch) if name == "full" else \
            make_variant(model, cfg, tx, name, n_inner, batch)
    else:
        cfg = build(_MODEL_TOGGLES.get(name), _LOSS_TOGGLES.get(name), _OPT_TOGGLES.get(name))
        model, state, tx = setup_state(cfg, schema, device)
        fn = make_full_step(model, cfg, tx, n_inner, batch)
    return fn, copy.deepcopy(state)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(name: str, fn, state, data, *, n_dispatch: int = N_DISPATCH, n_inner: int = N_INNER) -> dict:
    """One warm-up dispatch, then ``n_dispatch`` timed ones with one value
    fetched at the end; prints and returns ms/step."""
    _, notice_store, company_store, pairs = data
    t0 = time.perf_counter()
    state, out = fn(state, 99, pairs, notice_store, company_store)
    float(out.reshape(-1)[0])
    warm_s = time.perf_counter() - t0
    _sync(pairs.device)
    t0 = time.perf_counter()
    for i in range(n_dispatch):
        state, out = fn(state, 7 + i, pairs, notice_store, company_store)
    probe = float(out.reshape(-1)[0])
    elapsed = time.perf_counter() - t0
    ms = elapsed / (n_dispatch * n_inner) * 1e3
    print(f"{name:24s} {ms:7.3f} ms/step   (warm-up {warm_s:5.1f}s, probe {probe:.4f})", flush=True)
    return {"ms_per_step": ms, "warmup_s": warm_s, "probe": probe, "steps": (1 + n_dispatch) * n_inner}


def attribute(rows: dict) -> dict:
    """ms/step of each component from the ablations' differences (those
    whose variants were run)."""
    out = {}
    for part, a, b in ATTRIBUTION:
        if a in rows and (b is None or b in rows):
            out[part] = rows[a]["ms_per_step"] - (rows[b]["ms_per_step"] if b else 0.0)
    return out


def run_variants(want, *, device=None, data=None, batch: int = B, n_inner: int = N_INNER,
                 n_dispatch: int = N_DISPATCH, scale: str = "bench") -> dict:
    """Times each variant of ``want`` on ``device`` (None means the card);
    returns {name: row} and prints the attribution."""
    unknown = [n for n in want if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}; choose from {VARIANTS}")
    dev = resolve_device(device)
    data = data or setup_data(dev, scale=scale)
    base = setup_state(build(), data[0], dev)
    rows = {}
    for name in want:
        fn, state = prepare(name, data[0], dev, base, n_inner=n_inner, batch=batch)
        rows[name] = timeit(name, fn, state, data, n_dispatch=n_dispatch, n_inner=n_inner)
    parts = attribute(rows)
    if parts:
        print("attribution (ms/step): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return rows


def run_trace(*, device=None, data=None, batch: int = B, n_inner: int = N_INNER, n_dispatch: int = 3,
              top: int = 40, log_dir=None, scale: str = "bench") -> dict:
    """``n_dispatch`` dispatches of ``full`` under ``utils/profiling.trace``
    after a warm-up one; prints and returns the device-time table (per
    dispatch) and the busy share of the traced span."""
    dev = resolve_device(device)
    data = data or setup_data(dev, scale=scale)
    schema, notice_store, company_store, pairs = data
    fn, state = prepare("full", schema, dev, n_inner=n_inner, batch=batch)
    state, out = fn(state, 99, pairs, notice_store, company_store)
    float(out.reshape(-1)[0])
    log_dir = log_dir or tempfile.mkdtemp(prefix="step_trace_")
    with trace(log_dir) as prof:
        t0 = time.perf_counter()
        for i in range(n_dispatch):
            state, out = fn(state, 7 + i, pairs, notice_store, company_store)
        float(out.reshape(-1)[0])
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    table = device_table(prof, wall_us, n_dispatch, top)
    n_steps = n_dispatch * n_inner
    print(f"device op totals over {n_dispatch} dispatches ({n_steps} steps); trace: {log_dir}/trace.json")
    if table["busy_share"] is None:
        print("no device events in the traced span (a CPU run)")
    else:
        print(f"device busy share over the traced span: {table['busy_share']:6.1%} "
              f"(busy {table['device_ms_per_call'] * n_dispatch:.1f} ms / span {wall_us / 1e3:.1f} ms)")
    for name, ms in table["top_ms"].items():
        print(f"{ms * n_dispatch:9.3f} ms total  {ms / n_inner:7.3f} ms/step  {name}")
    return {**table, "steps": n_steps, "trace": f"{log_dir}/trace.json"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jodalrob_twotower_torch.profile_step",
                                description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="*", help=f"variants to time (default: all of {VARIANTS})")
    p.add_argument("--trace", action="store_true", help="trace 3 dispatches of 'full' instead of timing variants")
    p.add_argument("--dispatches", type=int, default=N_DISPATCH, help="timed dispatches per variant")
    p.add_argument("--batch-size", type=int, default=B)
    p.add_argument("--synthetic-scale", choices=["tiny", "bench"], default="bench")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.force_cpu else None)
    if dev.type == "cuda":
        from jodalrob_twotower_torch.bench import card_line

        print(card_line(), flush=True)
    print(f"device: {dev}, B={args.batch_size}, {N_INNER} steps per dispatch", flush=True)
    if args.trace:
        run_trace(device=dev, batch=args.batch_size, n_inner=N_INNER, scale=args.synthetic_scale)
    else:
        run_variants(args.variants or VARIANTS, device=dev, batch=args.batch_size, n_inner=N_INNER,
                     n_dispatch=args.dispatches, scale=args.synthetic_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
