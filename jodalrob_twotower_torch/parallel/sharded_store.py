"""Row-sharded feature stores on the mesh (port of
``jodalrob_twotower_tpu/parallel/sharded_store.py``).

With ``MeshConfig.store_sharding = "rows"`` each rank keeps the block
``[r N/n, (r+1) N/n)`` of the (dense [N, D], cat_ids [N, K]) store
matrices, padded to a multiple of n rows, instead of a whole copy: the
reference's answer to stores too large for one device. Batch rows come
through the exchange of the row-sharded tables
(``parallel/sharded_embedding.exchange_rows``), outside autograd since the
stores are inputs:

  1. every rank all-gathers the global batch's row ids (B ints);
  2. each rank gathers the ids in its row range from its own block and
     zeroes the rest;
  3. a reduce-scatter sums the contributions and hands each rank the rows
     of its own block of the batch.

Each row comes from one rank and the others add zeros, so the gather is
exact for float32, bfloat16 and integer matrices. Its wire cost per step
is B (D + K) elements whatever N is. Every rank must call it alike: the
evaluator pads its chunks to ``batch_multiple``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.parallel.mesh import DATA_AXIS
from jodalrob_twotower_torch.parallel.sharded_embedding import exchange_rows


def pad_rows_to(mat, multiple: int):
    """Zero-pad dim 0 up to a multiple (padding rows are never gathered:
    row ids come from the pair set, which indexes real rows only). A numpy
    array or a tensor; returned as is when no padding is needed."""
    n = mat.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return mat
    if isinstance(mat, torch.Tensor):
        return torch.cat([mat, mat.new_zeros((rem, *mat.shape[1:]))])
    pad = np.zeros((rem, *mat.shape[1:]), dtype=mat.dtype)
    return np.concatenate([mat, pad], axis=0)


def put_row_sharded_store(store: tuple, mesh, axis: str = DATA_AXIS) -> tuple[torch.Tensor, ...]:
    """The rank's block of each matrix of a host store tuple (dense [N, D],
    cat_ids [N, K]; numpy arrays or CPU tensors, every rank holding the
    same), padded to a multiple of the axis size, on the rank's device:
    the device holds N/n rows of each."""
    n_shards = mesh.shape[axis]
    out = []
    for m in store:
        m = m if isinstance(m, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(m))
        padded = pad_rows_to(m, n_shards)
        out.append(padded[mesh.block(padded.shape[0])].contiguous().to(mesh.device))
    return tuple(out)


def make_store_gather(mesh, axis: str = DATA_AXIS) -> Callable:
    """Build ``gather(mat, rows, total_rows=None) -> [b, D]``: ``mat`` the
    rank's block [N/n, D] of a row-sharded store of ``total_rows`` = N rows
    (default n times the block), ``rows`` int [b] the rank's block of the
    batch's store rows, the result their rows. Exact for float and integer
    matrices. N must divide the axis, as the reference requires."""
    n_shards = mesh.shape[axis]

    def gather(mat: torch.Tensor, rows: torch.Tensor, total_rows: int | None = None) -> torch.Tensor:
        n = mat.shape[0] * n_shards if total_rows is None else total_rows
        if n % n_shards or mat.shape[0] * n_shards != n:
            raise ValueError(
                f"store rows {n} and batch {rows.shape[0] * n_shards} must divide the {axis!r} axis "
                f"({n_shards}); pad the store with put_row_sharded_store"
            )
        return exchange_rows(mesh, mat, rows)

    return gather


def resolve_store_placement(cfg, mesh, axis: str = DATA_AXIS):
    """(store_gather, put_store) for a TrainConfig and a mesh: the one
    place ``MeshConfig.store_sharding`` is read (the dense indexed, sparse
    and sampled mesh steps and the trainer's eval). The reference's middle
    value, the stores' shardings, has no counterpart: each rank holds its
    tensors.

    "rows": the rank's block of each store matrix, batches through the
    exchange (:func:`make_tower_batch_gather`). "replicated": every rank's
    own copy of the host store on its device, batches through the plain
    gather (``store_gather`` None)."""
    if cfg.mesh.store_sharding == "rows":
        return make_tower_batch_gather(mesh, axis), lambda store: put_row_sharded_store(store, mesh, axis)

    def put_store(store):
        return tuple((x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x)))
                     .to(mesh.device) for x in store)

    return None, put_store


def make_tower_batch_gather(mesh, axis: str = DATA_AXIS) -> Callable:
    """``store_gather(store (dense, cat), rows [b]) -> TowerBatch``, the
    pluggable gather of the indexed train and eval steps and the sparse
    steps, over a row-sharded store. ``batch_multiple`` is the divisibility
    the exchange imposes: the evaluator reads it to pad its chunks."""
    gather = make_store_gather(mesh, axis)

    def store_gather(store, rows):
        dense, cat = store
        return TowerBatch(dense=gather(dense, rows), cat_ids=gather(cat, rows))

    store_gather.batch_multiple = mesh.shape[axis]
    return store_gather
