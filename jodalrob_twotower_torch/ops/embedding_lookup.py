"""Embedding-row gather (port of ``jodalrob_twotower_tpu/ops/embedding_lookup.py``).

Clamping happens in the caller (models/embedding.py); this gathers
already-valid absolute rows, one of two ways:

* the plain gather (``index_select``), the reference's XLA path;
* :func:`embedding_lookup_pallas`, the wrapper of the CUDA kernel
  ``csrc/row_gather.cu`` (K4), which replaces the TPU kernel
  ``embedding_lookup.py:46 _gather_kernel``. It gathers in the table's dtype
  (float32 or bfloat16), for int32 or int64 rows of any shape, each read at
  its own width; the TPU's padding of the ids to 256 per program existed
  only for its grid. A row outside [0, R) is clamped to the nearest edge
  row, as XLA's gather clamps (``jnp.take(..., mode="clip")``).

:func:`embedding_lookup_pallas_shard` is the same kernel's second form, a
mesh rank's masked gather from its block of a row-sharded table (the
reference's ``_exchange``, ``parallel/sharded_embedding.py:251-257``) in one
launch: rows of ids inside the block, zero rows elsewhere.

:func:`embedding_lookup` with ``use_pallas=True`` is differentiable through
a ``torch.autograd.Function``: the kernel forward and the reference's
``_lookup_bwd``, a scatter-add into zeros of the table's shape and dtype
with the cotangent cast to the table's dtype first (for a bfloat16 table
the sum runs in bfloat16, as XLA's does). The reference's backward is an
XLA scatter outside any Pallas kernel; here it is ``index_add_``.
"""

from __future__ import annotations

import ctypes

import torch

from jodalrob_twotower_torch.ops import _build


def embedding_lookup_pallas_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[rows] in the table's dtype, rows clamped into [0, R): table
    [R, D], rows int [...] -> [..., D]."""
    safe = rows.reshape(-1).long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, safe).reshape(*rows.shape, table.shape[1])


def local_rows(ids: torch.Tensor, offset: int, shard_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids - offset clamped into [0, shard_rows), in range): the block's
    row for each global id, and whether the id lies in the block."""
    local = ids.long() - offset
    in_range = (local >= 0) & (local < shard_rows)
    return local.clamp(0, shard_rows - 1), in_range


def embedding_lookup_pallas_shard_plain(block: torch.Tensor, ids: torch.Tensor, offset: int) -> torch.Tensor:
    """Rows ``ids`` (global, int [...]) of the table whose rows ``[offset,
    offset + R)`` are ``block`` [R, D]: the block's row where an id lies in
    it, zero elsewhere; [..., D] in the block's dtype."""
    local, in_range = local_rows(ids.reshape(-1), offset, block.shape[0])
    picked = block.index_select(0, local).masked_fill_(~in_range[:, None], 0)
    return picked.reshape(*ids.shape, block.shape[1])


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_gather")
    if not getattr(lib, "_typed", False):
        lib.row_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                           ctypes.c_void_p]
        lib.row_gather.restype = ctypes.c_int
        lib.row_gather_error_string.argtypes = [ctypes.c_int]
        lib.row_gather_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(table: torch.Tensor, rows: torch.Tensor, what: str) -> None:
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} must be [R, D] float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be int32 or int64, got {rows.dtype}")
    if table.device != rows.device:
        raise ValueError(f"{what} and rows must share a device, got {table.device}, {rows.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the row gather runs on CUDA or CPU tensors, got {table.device}")


def _launch(table: torch.Tensor, rows: torch.Tensor, offset: int, zero_outside: bool) -> torch.Tensor:
    """One launch of K4 on the current stream: the clamp form, or the zero
    form over the block at ``offset``. Counts on
    ``embedding_lookup_pallas.launches``."""
    total_rows, d = table.shape
    row_bytes = d * table.element_size()
    if row_bytes % 16 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(
            f"the kernel moves 16-byte row pieces: table must be contiguous, 16-byte aligned, "
            f"with rows a multiple of 16 bytes, got D={d} {table.dtype}"
        )
    flat = rows.reshape(-1).contiguous()
    out = torch.empty((flat.numel(), d), dtype=table.dtype, device=table.device)
    if flat.numel():
        lib = _lib()
        with torch.cuda.device(table.device):
            err = lib.row_gather(
                table.data_ptr(), flat.data_ptr(), out.data_ptr(), flat.numel(), row_bytes, total_rows,
                flat.element_size(), offset, int(zero_outside), torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"row_gather launch failed: {lib.row_gather_error_string(err).decode()}")
        embedding_lookup_pallas.launches += 1
    return out.reshape(*rows.shape, d)


def embedding_lookup_pallas(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K4, the row gather: (table [R, D] float32 or bfloat16, rows int32 or
    int64 [...]) -> [..., D] in the table's dtype; see
    :func:`embedding_lookup_pallas_plain` for the function.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    the kernel's launches, in both its forms."""
    _check(table, rows, "table")
    if table.device.type == "cpu":
        return embedding_lookup_pallas_plain(table, rows)
    return _launch(table, rows, 0, zero_outside=False)


embedding_lookup_pallas.launches = 0


def embedding_lookup_pallas_shard(block: torch.Tensor, ids: torch.Tensor, offset: int, *,
                                  total_rows: int | None = None) -> torch.Tensor:
    """K4's zero form, a mesh rank's masked gather in one launch: (block
    [R, D] float32 or bfloat16 holding rows ``[offset, offset + R)`` of a
    row-sharded table, ids int32 or int64 [...] of global rows) -> [..., D]
    in the block's dtype; see :func:`embedding_lookup_pallas_shard_plain`.
    With ``total_rows`` the block must lie inside a table of that many rows.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise. Counts on ``embedding_lookup_pallas.launches``."""
    _check(block, ids, "block")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    if total_rows is not None and offset + block.shape[0] > total_rows:
        raise ValueError(f"the block's rows [{offset}, {offset + block.shape[0]}) run past the table's {total_rows}")
    if block.device.type == "cpu":
        return embedding_lookup_pallas_shard_plain(block, ids, offset)
    return _launch(block, ids, int(offset), zero_outside=True)


def _lookup_bwd(shape: torch.Size, dtype: torch.dtype, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The table's gradient: g's rows scatter-added into zeros of the
    table's shape and dtype, g cast to that dtype before the add (the
    reference's ``_lookup_bwd``, embedding_lookup.py:136-143), at the rows
    the forward read (clamped, as the kernel clamps)."""
    safe = rows.reshape(-1).long().clamp(0, shape[0] - 1)
    grad = torch.zeros(shape, dtype=dtype, device=g.device)
    return grad.index_add_(0, safe, g.reshape(-1, shape[1]).to(dtype))


class _PallasLookup(torch.autograd.Function):
    """Forward: :func:`embedding_lookup_pallas`. Backward: :func:`_lookup_bwd`
    (the reference's ``_lookup_pallas_differentiable`` custom VJP)."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return embedding_lookup_pallas(table, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return _lookup_bwd(ctx.table_shape, ctx.table_dtype, rows, g), None


def embedding_lookup(table: torch.Tensor, rows: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """Gather ``table[rows]``; differentiable in ``table`` on both paths.
    table: [R, D]; rows: int [...]; -> [..., D] in the table's dtype."""
    if use_pallas:
        return _PallasLookup.apply(table, rows)
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[1])
