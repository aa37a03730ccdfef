"""Checkpointing: save and restore the whole train state in torch's own
format (port of ``jodalrob_twotower_tpu/train/checkpoint.py``, whose orbax
payload becomes one ``torch.save`` file per checkpoint).

The layout and its meaning are the reference's. Under ``directory``:

  epoch_<n>/   per-epoch checkpoints (the ``keep_n`` newest are kept)
  best/        the checkpoint with the lowest tracked metric
  final/       the last checkpoint, written by ``finalize``
  weights/     the weights only (params with the tables merged in, and the
               BatchNorm statistics): the serving entry point
  step_a/, step_b/ and step.json
               mid-epoch checkpoints, double-buffered behind a pointer file
  config.json  the TrainConfig of the run
  best.json    {"epoch": n, "metric": value}

Each checkpoint directory holds ``state.pt``, written to a temporary file
and moved into place with ``os.replace``, so a checkpoint is either whole or
absent. The payload holds every tensor of a :class:`TrainState` (params,
BatchNorm statistics, the optimizer's moments and accumulators) or a
:class:`SparseTrainState` (dense params, statistics, moments, both tables
and their Adagrad accumulators) at its own dtype, and the step, optimizer
count and dropout seed as ints, so a restored run continues bit for bit.
Files load with ``torch.load(..., weights_only=True)`` onto the target's
device: a checkpoint written on the CPU restores onto the card and back.

On a mesh (``mesh=``) rank 0 alone writes, each save ends in a barrier,
and every rank restores from the files. A row-sharded leaf (``sharded=``,
the model's row-sharded table keys, with their optimizer leaves; and a
sparse state's tables and accumulators on a mesh of more than one rank) is
gathered whole from every rank's block before the write, one leaf at a
time, onto rank 0's host, so a mesh checkpoint has exactly the keys and
shapes of one device's; a restore cuts each rank's block again. A mesh
checkpoint thus restores on one device, and one device's on a mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Mapping

import torch

from jodalrob_twotower_torch.config import CheckpointConfig, TrainConfig
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.train.sparse_tables import TABLE_KEYS, SparseTable, SparseTrainState, merged_params
from jodalrob_twotower_torch.train.train_step import TrainState

STATE_FILE = "state.pt"


def state_payload(state: TrainState | SparseTrainState) -> dict[str, Any]:
    """The checkpoint payload of a train state: nested dicts of tensors and
    ints, tagged with the state's kind."""
    if isinstance(state, SparseTrainState):
        return {
            "kind": "sparse", "step": int(state.step), "seed": int(state.seed),
            "dense_params": state.dense_params, "batch_stats": state.batch_stats, "opt_state": state.opt_state,
            "notice_table": dataclasses.asdict(state.notice_table),
            "company_table": dataclasses.asdict(state.company_table),
        }
    return {
        "kind": "dense", "step": int(state.step), "seed": int(state.seed),
        "params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state,
    }


def _conform(loaded, target, path: str):
    """``loaded`` checked against ``target``'s structure: the same keys, and
    every tensor of the same shape and dtype; ints stay ints."""
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != target.shape or loaded.dtype != target.dtype:
            got = (tuple(loaded.shape), loaded.dtype) if isinstance(loaded, torch.Tensor) else type(loaded).__name__
            raise ValueError(f"checkpoint leaf {path}: {got} does not fit the target's "
                             f"{(tuple(target.shape), target.dtype)}")
        return loaded
    if isinstance(target, Mapping):
        if not isinstance(loaded, Mapping) or set(loaded) != set(target):
            raise ValueError(f"checkpoint node {path}: keys {sorted(loaded) if isinstance(loaded, Mapping) else loaded}"
                             f" differ from the target's {sorted(target)}")
        return {k: _conform(loaded[k], target[k], f"{path}/{k}") for k in target}
    if isinstance(target, (bool, int, float, str)):
        if type(loaded) is not type(target):
            raise ValueError(f"checkpoint leaf {path}: {loaded!r} is not a {type(target).__name__}")
        return loaded
    raise TypeError(f"no checkpoint form for {path} of type {type(target).__name__}")


def state_from_payload(payload: Mapping[str, Any], target: TrainState | SparseTrainState):
    """A new state of ``target``'s type from a loaded payload that fits it."""
    want = state_payload(target)
    if payload.get("kind") != want["kind"]:
        raise ValueError(f"a {payload.get('kind')!r} checkpoint cannot restore into a {want['kind']!r} train state")
    p = _conform(dict(payload), want, "")
    if isinstance(target, SparseTrainState):
        return SparseTrainState(p["step"], p["dense_params"], p["batch_stats"], p["opt_state"],
                                SparseTable(**p["notice_table"]), SparseTable(**p["company_table"]), p["seed"])
    return TrainState(p["step"], p["params"], p["batch_stats"], p["opt_state"], p["seed"])


def _write_file(path: Path, payload) -> None:
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.replace(path)


def _map_leaves(node, fn, path: tuple = ()):
    """``node`` (nested dicts) with every tensor leaf t replaced by fn(path, t)."""
    if isinstance(node, torch.Tensor):
        return fn(path, node)
    if isinstance(node, Mapping):
        return {k: _map_leaves(v, fn, (*path, k)) for k, v in node.items()}
    return node


class CheckpointManager:
    """best/final/epoch/step checkpoint retention (layout in the module
    docstring)."""

    def __init__(self, directory: str | Path, cfg: CheckpointConfig | None = None, *, mesh=None,
                 sharded=frozenset()) -> None:
        self.dir = Path(directory)
        self.cfg = cfg or CheckpointConfig()
        self.mesh = mesh
        self._writes = mesh is None or mesh.is_main
        split = mesh is not None and mesh.size > 1
        # state_dict keys whose leaves (and optimizer leaves) are row-sharded
        self.sharded = frozenset(sharded) if split else frozenset()
        self._split = split  # a sparse state's tables are row-sharded on such a mesh
        self.dir.mkdir(parents=True, exist_ok=True)
        self._best_metric: float | None = None
        best_file = self.dir / "best.json"
        if best_file.exists():
            self._best_metric = json.loads(best_file.read_text()).get("metric")

    # -- save --------------------------------------------------------------
    def _saved(self) -> None:
        """The end of a save: on a mesh every rank waits until rank 0 has
        written, so that a restore on any rank reads whole files."""
        if self.mesh is not None:
            self.mesh.barrier()

    def save_config(self, cfg: TrainConfig) -> None:
        if self._writes:
            cfg.to_json(self.dir / "config.json")
        self._saved()

    def save_epoch(self, state, epoch: int, metric: float | None = None) -> None:
        """Save an epoch checkpoint; update best/ when the metric improves."""
        if self.cfg.save_every_epoch:
            self._write(self.dir / f"epoch_{epoch}", state)
            if self._writes:
                self._prune_epochs()
        if (
            self.cfg.save_best
            and metric is not None
            and (self._best_metric is None or metric < self._best_metric)
        ):
            self._best_metric = float(metric)
            self._write(self.dir / "best", state)
            if self._writes:
                _write_json(self.dir / "best.json", {"epoch": epoch, "metric": float(metric)})
        self._saved()

    def save_step(self, state, epoch: int, batch_in_epoch: int) -> None:
        """Mid-epoch checkpoint for preemption recovery.

        ``batch_in_epoch`` is the exact number of batches the epoch has
        consumed so far (recorded, not derived at resume). Double-buffered:
        the save goes to whichever of ``step_a/`` and ``step_b/`` the
        ``step.json`` pointer does not name, and the pointer is replaced
        atomically only after the save has landed, so a preemption during
        the write leaves the previous good checkpoint pointed to."""
        ptr = self.dir / "step.json"
        prev = json.loads(ptr.read_text())["dir"] if ptr.exists() else "step_b"
        nxt = "step_a" if prev == "step_b" else "step_b"
        self._write(self.dir / nxt, state)
        if self._writes:
            _write_json(ptr, {"dir": nxt, "epoch": int(epoch), "step": int(state.step), "batch": int(batch_in_epoch)})
        self._saved()

    def restore_step(self, target) -> tuple[Any, int, int, int | None] | None:
        """The newest mid-epoch checkpoint as (state, epoch, step,
        batch_in_epoch), or None if there is none. ``batch_in_epoch`` is
        None for a pointer written without it (callers derive it)."""
        ptr = self.dir / "step.json"
        if not ptr.exists():
            return None
        meta = json.loads(ptr.read_text())
        state = self.restore(meta["dir"], target)
        batch = meta.get("batch")
        return state, int(meta["epoch"]), int(meta["step"]), (int(batch) if batch is not None else None)

    def finalize(self, state) -> None:
        if self.cfg.save_final:
            self._write(self.dir / "final", state)
        # the weights-only export (the reference's model_weights.pt)
        self._write_params_only(self.dir / "weights", state)
        self._saved()

    def _is_sharded(self, path: tuple, sparse: bool) -> bool:
        """Whether the payload leaf at ``path`` (of a sparse state's payload
        or weights, with ``sparse``) is a rank's block of rows."""
        return path[-1] in self.sharded or (sparse and self._split and (
            path[0] in TABLE_KEYS.values() or (path[0] == "params" and path[-1] in TABLE_KEYS)))

    def gathered_payload(self, state):
        """The checkpoint payload of ``state`` as rank 0 writes it: every
        row-sharded leaf gathered whole onto its host (None on the other
        ranks; every rank must call it)."""
        return self._joined(state_payload(state), isinstance(state, SparseTrainState))

    def _joined(self, payload, sparse: bool):
        """``payload`` with every row-sharded leaf gathered whole, on rank
        0's host (a collective: every rank calls it; the others get None
        in its place)."""
        if not (self.sharded or (sparse and self._split)):
            return payload

        def join(path, t):
            if not self._is_sharded(path, sparse):
                return t
            whole = self.mesh.all_gather_rows(t)
            return whole.cpu() if self._writes else None

        return _map_leaves(payload, join)

    def _load(self, name: str, device, sparse: bool = False) -> dict:
        """A checkpoint file's payload on ``device``, each row-sharded leaf
        cut to this rank's block (the file read on the host first then)."""
        if not (self.sharded or (sparse and self._split)):
            return torch.load(self.dir / name / STATE_FILE, map_location=device, weights_only=True)
        payload = torch.load(self.dir / name / STATE_FILE, map_location="cpu", weights_only=True)

        def cut(path, t):
            if self._is_sharded(path, sparse):
                t = t[self.mesh.block(t.shape[0])].clone()  # not a view of the whole leaf
            return t.to(device)

        return _map_leaves(payload, cut)

    def _write(self, path: Path, state) -> None:
        payload = self.gathered_payload(state)
        if self._writes:
            _write_file(path, payload)

    def _write_params_only(self, path: Path, state) -> None:
        sparse = isinstance(state, SparseTrainState)
        params = merged_params(state) if sparse else state.params
        payload = self._joined({"params": params, "batch_stats": state.batch_stats}, sparse)
        if self._writes:
            _write_file(path, payload)

    _EPOCH_RE = re.compile(r"^epoch_(\d+)$")

    def _epoch_dirs(self) -> list[tuple[int, Path]]:
        """Complete epoch checkpoints only: a directory named exactly
        ``epoch_<int>`` that holds its state file (an interrupted save
        leaves at most a temporary file, never a partial state file)."""
        out = []
        for p in self.dir.glob("epoch_*"):
            m = self._EPOCH_RE.match(p.name)
            if m and p.is_dir() and (p / STATE_FILE).exists():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _prune_epochs(self) -> None:
        epochs = self._epoch_dirs()
        for _, p in epochs[: max(len(epochs) - self.cfg.keep_n, 0)]:
            shutil.rmtree(p)

    # -- restore -----------------------------------------------------------
    def latest_epoch(self) -> int | None:
        epochs = self._epoch_dirs()
        return epochs[-1][0] if epochs else None

    def restore(self, name: str, target):
        """Restore checkpoint ``name`` ('best', 'final', 'epoch_N', 'step_a')
        as a new state of ``target``'s type, structure and device (an
        initialized state; on a mesh, the rank's); raises if the checkpoint
        does not fit it."""
        return state_from_payload(self._load(name, target.device, isinstance(target, SparseTrainState)), target)

    def restore_latest(self, target):
        """(state, epoch) of the newest epoch checkpoint, or None."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        return self.restore(f"epoch_{epoch}", target), epoch

    def restore_weights(self, template: Mapping[str, torch.Tensor] | None = None, *, device=None) -> dict:
        """The weights-only export as {'params', 'batch_stats'}, each keyed
        as the model's ``state_dict``, on ``device`` (None means the card):
        the serving entry point, with no optimizer state and no step.
        ``template`` (a model's ``state_dict``) checks that every key, shape
        and dtype fits the model that will take them."""
        payload = self._load("weights", resolve_device(device))
        if template is not None:
            got = {**payload["params"], **payload["batch_stats"]}
            _conform(got, {k: template[k] for k in template}, "weights")
        return {"params": payload["params"], "batch_stats": payload["batch_stats"]}
