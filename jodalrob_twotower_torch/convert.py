"""Map the reference's flax variables onto the port's ``state_dict``, and
back (:func:`state_dict_to_flax`, which the parity tests use to compare
every leaf after training steps).

flax keeps a Dense kernel as ``[in, out]``, torch a Linear weight as
``[out, in]``; flax splits BatchNorm into ``params`` (``scale``, ``bias``)
and ``batch_stats`` (``mean``, ``var``). The module names are the same on
both sides (models/tower.py), so for a torch key ``notice_tower.mlp_0.weight``
the flax leaf is ``params/notice_tower/mlp_0/kernel``, transposed:

=====================================  ============================================
torch                                  flax
=====================================  ============================================
``<layer>.weight`` (Linear)            ``params/<layer>/kernel``, transposed
``<layer>.bias`` (Linear)              ``params/<layer>/bias``
``<bn>.weight`` / ``<bn>.bias``        ``params/<bn>/scale`` / ``params/<bn>/bias``
``<bn>.running_mean`` / ``_var``       ``batch_stats/<bn>/mean`` / ``batch_stats/<bn>/var``
``<tower>.embeddings.table``           ``params/<tower>/embeddings/table``, as is
=====================================  ============================================

Every torch entry must find its leaf with the right shape, and every flax
leaf must be used; anything else raises ``ValueError``.

A mesh model with row-sharded tables (``model.row_sharded_keys``) holds
its rank's block of each table: :func:`flax_to_state_dict` cuts the flax
table to that block (``parallel/mesh.shard_state``) and
:func:`state_dict_to_flax` joins the blocks whole again
(``parallel/mesh.join_state``, a collective every rank calls), so a mesh
state from the reference's parameters is one device's state cut into
blocks.

:func:`flax_to_sparse_state` carries the reference's ``SparseTrainState``
(train/sparse_tables.py) into the port's: its dense params and batch
statistics through the same map, its two tables and their accumulators as
they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.models.embedding import EmbeddingCollection
from jodalrob_twotower_torch.models.tower import BatchNorm
from jodalrob_twotower_torch.parallel.mesh import join_state, shard_state


def _flatten(tree: Mapping | None, root: str) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, f"{path}/{key}")
        else:
            out[path] = np.asarray(node)

    walk(tree or {}, root)
    return out


def _sources(model: nn.Module):
    """(torch key, flax path, transpose) for every entry of the state_dict."""
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, nn.Linear):
            yield f"{name}.weight", f"params/{path}/kernel", True
            yield f"{name}.bias", f"params/{path}/bias", False
        elif isinstance(module, BatchNorm):
            yield f"{name}.weight", f"params/{path}/scale", False
            yield f"{name}.bias", f"params/{path}/bias", False
            yield f"{name}.running_mean", f"batch_stats/{path}/mean", False
            yield f"{name}.running_var", f"batch_stats/{path}/var", False
        elif isinstance(module, EmbeddingCollection):
            yield f"{name}.table", f"params/{path}/table", False


def _row_mesh(model: nn.Module):
    """The mesh of ``model``'s row-sharded tables, or None."""
    return next((m.row_mesh for m in model.modules() if isinstance(m, EmbeddingCollection)
                 and m.row_mesh is not None), None)


def _whole_shapes(model: nn.Module) -> dict[str, tuple]:
    """``model``'s state_dict shapes, a row-sharded table's whole."""
    out = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for name, m in model.named_modules():
        if isinstance(m, EmbeddingCollection):
            out[f"{name}.table"] = (m.total_rows, m.embed_dim)
    return out


def flax_to_state_dict(
    model: nn.Module, params: Mapping, batch_stats: Mapping | None = None
) -> dict[str, torch.Tensor]:
    """``model``'s state_dict filled from flax ``params`` and ``batch_stats``
    (nested dicts of numpy arrays, rooted at the towers, e.g.
    ``params["notice_tower"]["proj_bidntcenm"]["kernel"]``); a row-sharded
    table cut to the rank's block."""
    leaves = {**_flatten(params, "params"), **_flatten(batch_stats, "batch_stats")}
    expected = _whole_shapes(model)
    out: dict[str, torch.Tensor] = {}
    for key, path, transpose in _sources(model):
        if path not in leaves:
            raise ValueError(f"flax variables lack {path} (for {key})")
        value = leaves.pop(path)
        value = value.T if transpose else value
        want = expected[key]
        if value.shape != want:
            raise ValueError(
                f"{path} has shape {value.shape}{' transposed' if transpose else ''}, "
                f"{key} needs {want}"
            )
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))  # a writable copy
    missing = set(expected) - set(out)
    if missing:
        raise ValueError(f"no flax source known for {sorted(missing)}")
    if leaves:
        raise ValueError(f"flax leaves with no place in the model: {sorted(leaves)}")
    mesh = _row_mesh(model)
    return shard_state(out, mesh, model.row_sharded_keys) if mesh is not None else out


def state_dict_to_flax(
    model: nn.Module, state_dict: Mapping[str, torch.Tensor]
) -> tuple[dict, dict]:
    """The inverse of :func:`flax_to_state_dict`: (params, batch_stats) as
    nested dicts of float32 numpy arrays in flax's layout, from a state_dict
    of ``model`` (a TrainState's ``state_dict`` included); row-sharded
    tables joined whole (every rank of their mesh must call it)."""
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    expected = set(model.state_dict())
    if set(state_dict) != expected:
        raise ValueError(
            f"state_dict keys differ from the model's: missing {sorted(expected - set(state_dict))}, "
            f"extra {sorted(set(state_dict) - expected)}"
        )
    mesh = _row_mesh(model)
    if mesh is not None:
        state_dict = join_state(dict(state_dict), mesh, model.row_sharded_keys)
    for key, path, transpose in _sources(model):
        value = state_dict[key].detach().to("cpu", torch.float32).numpy()
        value = np.ascontiguousarray(value.T if transpose else value)
        root, *parts = path.split("/")
        node = trees[root]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return trees["params"], trees["batch_stats"]


def flax_to_sparse_state(
    model: nn.Module,
    cfg,
    dense_params: Mapping,
    batch_stats: Mapping | None,
    tables: Mapping[str, tuple[np.ndarray, np.ndarray]],
    total_steps: int,
    *,
    seed: int = 0,
    device=None,
):
    """The port's (SparseTrainState, dense optimizer) from the reference's
    sparse state at step 0, as numpy arrays: ``dense_params`` and
    ``batch_stats`` as in :func:`flax_to_state_dict` (the towers without
    their ``embeddings``), ``tables`` {"notice_tower": (table [R, D],
    accumulator [R, 1]), "company_tower": ...}. The converted weights are
    loaded into ``model`` on the way. The dense optimizer starts fresh, as
    ``create_sparse_train_state``'s does. On ``device`` (None means the
    card)."""
    from jodalrob_twotower_torch.train.sparse_tables import TABLE_KEYS, SparseTable, create_sparse_train_state

    params = {tower: dict(p) for tower, p in dense_params.items()}
    for tower, (table, _) in tables.items():
        params[tower]["embeddings"] = {"table": table}
    model.load_state_dict(flax_to_state_dict(model, params, batch_stats))
    state, tx = create_sparse_train_state(model, cfg, seed, total_steps, device=device)
    dev = resolve_device(device)
    for key, field in TABLE_KEYS.items():
        table, acc = tables[key.split(".")[0]]
        setattr(state, field, SparseTable(torch.from_numpy(np.array(table, np.float32)).to(dev),
                                          torch.from_numpy(np.array(acc, np.float32)).to(dev)))
    return state, tx
