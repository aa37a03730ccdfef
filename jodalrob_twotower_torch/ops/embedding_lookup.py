"""Embedding-row gather (port of ``jodalrob_twotower_tpu/ops/embedding_lookup.py``).

Clamping happens in the caller (models/embedding.py); this gathers
already-valid absolute rows, one of two ways:

* the plain gather (``index_select``), the reference's XLA path;
* :func:`embedding_lookup_pallas`, the wrapper of the CUDA kernel
  ``csrc/row_gather.cu``, which replaces the TPU kernel
  ``embedding_lookup.py:46 _gather_kernel``. It gathers in the table's dtype
  (float32 or bfloat16), for rows of any shape; the TPU's padding of the ids
  to 256 per program existed only for its grid. A row outside [0, R) is
  clamped to the nearest edge row, as XLA's gather clamps.

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_gather")
    if not getattr(lib, "_typed", False):
        lib.row_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                                           ctypes.c_void_p]
        lib.row_gather.restype = ctypes.c_int
        lib.row_gather_error_string.argtypes = [ctypes.c_int]
        lib.row_gather_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def embedding_lookup_pallas(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K4, the row gather: (table [R, D] float32 or bfloat16, rows int
    [...]) -> [..., D] in the table's dtype; see
    :func:`embedding_lookup_pallas_plain` for the function.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. ``launches`` counts
    the kernel's launches."""
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table must be [R, D] float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be int32 or int64, got {rows.dtype}")
    if table.device != rows.device:
        raise ValueError(f"table and rows must share a device, got {table.device}, {rows.device}")
    if table.device.type == "cpu":
        return embedding_lookup_pallas_plain(table, rows)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_lookup_pallas runs on CUDA or CPU tensors, got {table.device}")
    total_rows, d = table.shape
    row_bytes = d * table.element_size()
    if row_bytes % 16 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(
            f"the kernel moves 16-byte row pieces: table must be contiguous, 16-byte aligned, "
            f"with rows a multiple of 16 bytes, got D={d} {table.dtype}"
        )
    flat = rows.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((flat.numel(), d), dtype=table.dtype, device=table.device)
    if flat.numel():
        lib = _lib()
        with torch.cuda.device(table.device):
            err = lib.row_gather(
                table.data_ptr(), flat.data_ptr(), out.data_ptr(), flat.numel(), row_bytes, total_rows,
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"row_gather launch failed: {lib.row_gather_error_string(err).decode()}")
        embedding_lookup_pallas.launches += 1
    return out.reshape(*rows.shape, d)


embedding_lookup_pallas.launches = 0


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
