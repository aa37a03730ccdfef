"""The training driver for sparse tables: ``drivers/train.py``'s calls,
window and trace over the program's sampled sparse steps
(``train/sparse_tables.make_sampled_sparse_steps``): each step looks its
rows up outside autograd and updates only them, by rowwise Adagrad, while
AdamW updates the rest.

The check reads what ``drivers/train.py``'s does, the tables included: the
dense leaves' gradients and changes from the tap on the optimizer, and each
table's gradient at the first step (its occurrences' cotangents summed into
the table's rows, as a dense step's gradient has them) and its change when
the fourth step starts, from a tap on ``sparse_tables.update_shard``. The
reference is the dense one: rowwise Adagrad leaves a row that no id read as
it was, so the two updates are one function.
"""

from __future__ import annotations

import torch

from benchmark import gen, spec, trace
from benchmark.drivers import common, train
from benchmark.drivers.common import Clock
from jodalrob_twotower_torch.train import sparse_tables
from jodalrob_twotower_torch.train.train_step import resolve_store_dtype


class TableTap:
    """``train.UpdateTap`` on the dense leaves, and the tables' gradients at
    the first step and changes at the fourth from their updates."""

    def __init__(self, state, tx, n_steps: int) -> None:
        self.dense = train.UpdateTap(tx, state.dense_params, n_steps)
        self.tables = {k: getattr(state, f) for k, f in sparse_tables.TABLE_KEYS.items()}
        self.start = {k: st.table.detach().clone() for k, st in self.tables.items()}
        self.grad_norms, self.change_norms, self.n_steps = {}, {}, n_steps
        self.inner, self.calls = sparse_tables.update_shard, {k: 0 for k in self.tables}
        sparse_tables.update_shard = self

    def __call__(self, st, rows, grads, mesh, **kw):
        key = next(k for k, t in self.tables.items() if t is st)
        self.calls[key] += 1
        if self.calls[key] == 1:
            g = torch.zeros_like(st.table).index_add_(0, rows.long(), grads.to(st.table.dtype))
            self.grad_norms[key] = float(g.norm(dtype=torch.float64))
        if self.calls[key] == self.n_steps + 1:
            self.change_norms[key] = float((st.table - self.start.pop(key)).norm(dtype=torch.float64))
        return self.inner(st, rows, grads, mesh, **kw)

    def close(self) -> dict:
        sparse_tables.update_shard = self.inner
        self.dense.close()
        self.start = {}
        return {"grad_norms": {**self.dense.grad_norms, **self.grad_norms},
                "change_norms": {**self.dense.change_norms, **self.change_norms}}


class Run(train.Run):
    def __init__(self, cell: dict, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg_spec, self.traffic = cell["config_spec"], cell["traffic_spec"]
        self.card_window = any(m["source"] == "device_trace" for m in cell["end_to_end"])
        t = self.traffic
        self.batch, self.per_call = t["batch_size"], t["steps_per_call"]
        if self.per_call <= train.CHECK_STEPS:
            raise ValueError(f"steps_per_call must exceed {train.CHECK_STEPS}: the check reads the fourth step")
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
        self.state, tx = sparse_tables.create_sparse_train_state(model, cfg, self.state_seed, t["schedule_steps"],
                                                                 device=self.device)
        model.to("meta")
        del w
        self.steps = sparse_tables.make_sampled_sparse_steps(model, cfg, tx, t["schedule_steps"], self.per_call,
                                                             self.batch)
        clock("weights and state")
        tap = TableTap(self.state, tx, train.CHECK_STEPS)
        try:
            losses = self._call()
        finally:
            norms = tap.close()
        self.prog = {"losses": losses[:train.CHECK_STEPS].tolist(), **norms}
        self.check_failed = int((~torch.isfinite(losses)).sum())
        clock("check call")
        for _ in range(t.get("warm_calls", 1)):
            self._call()
        if self.card_window:
            trace.card_busy(self._call)
        self.phases = clock("warm calls")


control = train.control
