"""The training driver: the program's sampled training steps
(``train/train_step.make_sampled_train_steps``) over stores and pairs on the
card, calls of ``steps_per_call`` steps, each ended by fetching its losses
(``bench.py``'s loop).

Set-up builds one train state and one steps object and hands them to the
window. Its first call is the check: it runs through the window's own call
and feed while a tap on the optimizer's ``update`` reads each leaf's
gradient as the optimizer gets it at the first step and each leaf's change
when the fourth step starts (after three updates); the tap is removed
before anything is timed. After the window the program's state is freed and
the reference follows the same first three steps (``reference/train.py``).

A cell whose end-to-end metrics come from the card's trace (a host-bound
step, whose host-clock rate moves with the machine's shared cores) traces
its window call by call with the card's activity only and reports the
card's busy milliseconds a step over every step of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import flops, gen, judge, spec, trace
from benchmark.drivers import common
from benchmark.drivers.common import Clock
from benchmark.reference import model as ref_model
from benchmark.reference.train import first_steps
from jodalrob_twotower_torch.train.train_step import create_train_state, make_sampled_train_steps, resolve_store_dtype

CHECK_STEPS = 3


class UpdateTap:
    """Wraps ``tx.update`` on the instance for the check call only."""

    def __init__(self, tx, params: dict, n_steps: int) -> None:
        self.tx, self.inner, self.n_steps, self.calls = tx, tx.update, n_steps, 0
        self.start = {k: v.detach().clone() for k, v in params.items()}
        self.grad_norms = self.change_norms = None
        tx.update = self

    def __call__(self, params, grads, opt_state, **kw):
        self.calls += 1
        if self.calls == 1:
            self.grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
        if self.calls == self.n_steps + 1:
            self.change_norms = {k: float((params[k] - self.start[k]).double().norm()) for k in params}
            self.start = None
        return self.inner(params, grads, opt_state, **kw)

    def close(self) -> None:
        del self.tx.update
        self.start = None


class Run:
    def __init__(self, cell: dict, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg_spec, self.traffic = cell["config_spec"], cell["traffic_spec"]
        self.card_window = any(m["source"] == "device_trace" for m in cell["end_to_end"])
        t = self.traffic
        self.batch, self.per_call = t["batch_size"], t["steps_per_call"]
        if self.per_call <= CHECK_STEPS:
            raise ValueError(f"steps_per_call must exceed {CHECK_STEPS}: the check reads the fourth step")
        self.sample_seed = spec.derive(seed, "sample")
        self.state_seed = spec.derive(seed, "dropout")
        clock = Clock()
        cfg = common.program_config(self.cfg_spec)
        data = gen.make_data(self.cfg_spec["schema"], t, spec.derive(seed, "data"), self.device)
        store_dtype = resolve_store_dtype(cfg)
        self.stores = [(d if store_dtype is None else d.to(store_dtype), c) for d, c in (data["notice"], data["company"])]
        self.pairs = data["pairs"]
        del data
        clock("data")
        model, w = common.program_model(self.cfg_spec, spec.derive(seed, "weights"), self.device)
        self.state, tx = create_train_state(model, cfg, self.state_seed, t["schedule_steps"], device=self.device)
        model.to("meta")  # the state holds the weights now; the model is structure only
        del w
        self.steps = make_sampled_train_steps(model, cfg, tx, self.per_call, self.batch)
        clock("weights and state")
        tap = UpdateTap(tx, self.state.params, CHECK_STEPS)
        losses = self._call()
        tap.close()
        self.prog = {"losses": losses[:CHECK_STEPS].tolist(), "grad_norms": tap.grad_norms,
                     "change_norms": tap.change_norms}
        self.check_failed = int((~torch.isfinite(losses)).sum())
        clock("check call")
        for _ in range(t.get("warm_calls", 1)):
            self._call()
        if self.card_window:
            trace.card_busy(self._call)  # the profiler's first session starts its tracer
        self.phases = clock("warm calls")

    def _call(self) -> torch.Tensor:
        self.state, metrics = self.steps(self.state, self.sample_seed, self.pairs, *self.stores)
        return metrics["loss"].cpu()

    def _calls(self, *, seconds: float | None = None, n: int | None = None) -> dict:
        steps = bad = 0
        ends = [time.perf_counter()]
        while True:
            losses = self._call()
            steps += losses.numel()
            bad += int((~torch.isfinite(losses)).sum())
            ends.append(time.perf_counter())
            elapsed = ends[-1] - ends[0]
            if (n is not None and len(ends) > n) or (seconds is not None and elapsed >= seconds):
                return {"steps": steps, "bad": bad, "elapsed": elapsed, "call_s": np.diff(ends)}

    def window(self, seconds: float) -> dict:
        if self.card_window:
            return self._card_window(seconds)
        r = self._calls(seconds=seconds)
        return {"examples_per_s": r["steps"] * self.batch / r["elapsed"], "window_s": r["elapsed"],
                "attempted": r["steps"], "failed": r["bad"] + self.check_failed,
                "call_ms": np.percentile(r["call_s"] * 1e3, [0, 50, 95, 100]).tolist()}

    def _card_window(self, seconds: float) -> dict:
        """Whole calls, each traced on the card, until ``seconds`` have
        passed: the card's busy time over every step of the window."""
        steps = bad = 0
        busy_s = 0.0
        t0 = time.perf_counter()
        while True:
            losses, busy = trace.card_busy(self._call)
            steps += losses.numel()
            bad += int((~torch.isfinite(losses)).sum())
            busy_s += busy
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"card_ms_per_step": 1e3 * busy_s / steps if busy_s else None, "card_busy_s": busy_s,
                "window_s": elapsed, "attempted": steps, "failed": bad + self.check_failed}

    def traced_window(self, traced) -> dict:
        """``trace_calls`` calls in each of the trace's passes: the model
        FLOPs and their seconds, the untraced pass's rate, and the layer
        facts of the steps that the card-only pass traced."""
        n = self.traffic["trace_calls"]
        runs, summary = traced(lambda: {"first": self.state.step, **self._calls(n=n)})
        plain, dev = runs[0], runs[1]
        summary.update(self._layer_facts(dev["first"], dev["steps"]))
        # the step's share of the peak over the seconds the cell's end-to-end
        # metric counts: the card's busy time where that is the metric, else
        # the untraced pass's host clock, since the profiler slows the host
        if self.card_window:
            summary.update(model_flops=summary["step_flops"] * dev["steps"], flops_s=summary["busy_s"])
        else:
            summary.update(model_flops=summary["step_flops"] * plain["steps"], flops_s=summary["plain_window_s"])
        summary.update(host_examples_per_s=plain["steps"] * self.batch / summary["plain_window_s"],
                       attempted=sum(r["steps"] for r in runs),
                       failed=sum(r["bad"] for r in runs) + self.check_failed)
        return summary

    def _layer_facts(self, first_step: int, n_steps: int) -> dict:
        """What the readers need beside the trace: the steps and their model
        FLOPs, the loss's shape and, per tower, the ids each step looked up
        and how many distinct table rows they touched (worked out from the
        sampling rule, as the reference draws its rows)."""
        schema, model = self.cfg_spec["schema"], self.cfg_spec["train_config"]["model"]
        lookups = {}
        for i, side in enumerate(("notice", "company")):
            s = schema[side]
            offsets = ref_model.row_offsets(s["vocab_sizes"]).to(self.device)
            vmax = torch.tensor(s["vocab_sizes"], device=self.device) - 1
            unique = []
            for step in range(first_step, first_step + n_steps):
                rows = ref_model.batch_rows(self.device, self.sample_seed, step, self.pairs.shape[0], self.batch)
                ids = self.stores[i][1].index_select(0, self.pairs[rows, i])
                unique.append(int(torch.unique(torch.minimum(ids.long().clamp(min=0), vmax) + offsets).numel()))
            lookups[side] = {"features": len(s["vocab_sizes"]), "dim": model["categorical_embedding_dim"],
                             "table_rows": int(offsets[-1]) + -(-s["vocab_sizes"][-1] // 128) * 128,
                             "unique_rows": unique}
        return {"steps": n_steps, "batch": self.batch, "final_dim": model["final_embedding_dim"],
                "step_flops": flops.train_step_flops(self.cfg_spec, self.batch), "lookups": lookups}

    def release(self) -> None:
        self.state = self.steps = self.stores = self.pairs = None

    def judge(self) -> dict:
        """The comparison's numbers: the program's check steps against the
        reference's float32 steps. Call after :meth:`release`."""
        return judge.train_numbers(self.prog, reference_steps(self.cell, self.seed, self.device))


def control(cell: dict, seed: int, device) -> dict:
    """The control's numbers: the reference in float8 put in the program's
    place, judged against the float32 reference."""
    return judge.train_numbers(reference_steps(cell, seed, device, prec="fp8"), reference_steps(cell, seed, device))


def reference_steps(cell: dict, seed: int, device, prec: str = "f32") -> dict:
    """The reference's first steps for ``seed``, from freshly generated
    weights and data (the same draws the program got)."""
    cfg_spec, traffic = cell["config_spec"], cell["traffic_spec"]
    data = gen.make_data(cfg_spec["schema"], traffic, spec.derive(seed, "data"), device)
    w = common.weights(cfg_spec, spec.derive(seed, "weights"), device)
    return first_steps(w, data, cfg_spec["schema"], cfg_spec["train_config"], sample_seed=spec.derive(seed, "sample"),
                       state_seed=spec.derive(seed, "dropout"), batch=traffic["batch_size"],
                       total_steps=traffic["schedule_steps"], n_steps=CHECK_STEPS, prec=prec)
