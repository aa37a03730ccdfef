"""One-hot embedding lookup on the unified table and its dense table
gradient (port of ``jodalrob_twotower_tpu/ops/embedding_grad.py``).

* :func:`dense_table_lookup` wraps the CUDA kernel ``csrc/onehot_lookup.cu``,
  which replaces the TPU kernel ``embedding_grad.py:358 _lookup_kernel``.
  The TPU computed the lookup as a one-hot matmul because its row DMAs were
  slow; the Hopper kernel is a direct row gather with the same result,
  emitted in the towers' ``[B, K, D]`` layout.
* :func:`dense_table_grad` wraps ``csrc/table_grad.cu``, which replaces the
  TPU kernel ``embedding_grad.py:45 _grad_kernel`` (both orientations): the
  dense ``[R, D]`` f32 table gradient, read from the cotangent in its native
  ``[B, K, D]`` layout (the TPU's ``[D, R]`` transposed output existed only
  for its lanes).
* :func:`dense_table_grad_bmajor` wraps the same kernel with a transposed
  store, which replaces ``embedding_grad.py:227 _grad_kernel_bmajor``: the
  ``[D, R]`` result of ``dense_table_grad_bmajor``, K2's output transposed
  bit for bit. As in the JAX package, no path calls it.
* :func:`make_onehot_lookup` is a ``torch.autograd.Function`` with the
  lookup kernel forward and the gradient kernel backward;
  :func:`make_dense_grad_lookup` a plain gather forward with the gradient
  kernel backward.

``*_plain`` are the same functions in plain PyTorch: the CPU path and the
reference the card's runs are held against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jodalrob_twotower_torch.ops import _build

# Every 128-row tile of the unified table belongs to exactly one feature
# (models/embedding.ROW_ALIGNMENT).
TILE_ROWS = 128


def dense_table_lookup_plain(
    table: torch.Tensor, rows: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """emb[b, k, :] = bf16(table[rows[b, k]]) where rows[b, k] lies in feature
    k's tile block (tile_feature[row // 128] == k), else 0. -> [B, K, D] bf16."""
    total_rows = table.shape[0]
    safe = rows.clamp(0, total_rows - 1).long()
    features = torch.arange(rows.shape[1], device=rows.device)
    in_block = (rows >= 0) & (rows < total_rows) & (tile_feature[safe // TILE_ROWS] == features)
    emb = table.index_select(0, safe.reshape(-1)).reshape(*rows.shape, -1).to(torch.bfloat16)
    return torch.where(in_block[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))


def _lib() -> ctypes.CDLL:
    lib = _build.load("onehot_lookup")
    if not getattr(lib, "_typed", False):
        for fn in (lib.onehot_lookup_f32, lib.onehot_lookup_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.onehot_lookup_error_string.argtypes = [ctypes.c_int]
        lib.onehot_lookup_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(table: torch.Tensor, rows: torch.Tensor, tile_feature: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table must be [R, D] float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be [B, K] int32, got {tuple(rows.shape)} {rows.dtype}")
    total_rows, d = table.shape
    if total_rows % TILE_ROWS or tile_feature.shape != (total_rows // TILE_ROWS,):
        raise ValueError(
            f"table rows ({total_rows}) must be a multiple of {TILE_ROWS} with one "
            f"tile_feature entry per tile, got tile_feature {tuple(tile_feature.shape)}"
        )
    if tile_feature.dtype != torch.int32:
        raise ValueError(f"tile_feature must be int32, got {tile_feature.dtype}")
    if d % 8:
        raise ValueError(f"embed dim must be a multiple of 8 (16-byte row pieces), got {d}")
    if not (table.is_contiguous() and rows.is_contiguous() and tile_feature.is_contiguous()):
        raise ValueError("table, rows and tile_feature must be contiguous")
    if not (table.device == rows.device == tile_feature.device):
        raise ValueError(
            f"table, rows and tile_feature must share a device, got "
            f"{table.device}, {rows.device}, {tile_feature.device}"
        )


def dense_table_lookup(
    table: torch.Tensor, rows: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """The one-hot lookup: (table [R, D], rows [B, K] absolute int32 rows,
    tile_feature [R/128] int32) -> [B, K, D] bf16; see
    :func:`dense_table_lookup_plain` for the function.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream, or raise: there is no fallback. ``launches`` counts the
    kernel's launches."""
    _check(table, rows, tile_feature)
    if table.device.type == "cpu":
        return dense_table_lookup_plain(table, rows, tile_feature)
    if table.device.type != "cuda":
        raise ValueError(f"dense_table_lookup runs on CUDA or CPU tensors, got {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned for the kernel's vector loads")
    b, k = rows.shape
    total_rows, d = table.shape
    out = torch.empty((b, k, d), dtype=torch.bfloat16, device=table.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    launch = lib.onehot_lookup_f32 if table.dtype == torch.float32 else lib.onehot_lookup_bf16
    with torch.cuda.device(table.device):
        err = launch(
            table.data_ptr(), rows.data_ptr(), tile_feature.data_ptr(), out.data_ptr(),
            b * k, k, d, total_rows, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"onehot_lookup launch failed: {lib.onehot_lookup_error_string(err).decode()}"
        )
    dense_table_lookup.launches += 1
    return out


dense_table_lookup.launches = 0


# -- the dense table gradient ----------------------------------------------------


def dense_table_grad_plain(
    rows: torch.Tensor, g: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """dT [R, D] f32 (R = 128 * len(tile_feature)): dT[v] = sum of
    f32(bf16(g[b, k])) over the (b, k) with rows[b, k] == v in feature k's
    tile block; other rows (another feature's block, -1, past the table)
    contribute nothing."""
    total_rows = TILE_ROWS * tile_feature.shape[0]
    b, k = rows.shape
    d = g.shape[-1]
    safe = rows.clamp(0, total_rows - 1).long()
    features = torch.arange(k, device=rows.device)
    in_block = (rows >= 0) & (rows < total_rows) & (tile_feature[safe // TILE_ROWS] == features)
    vals = g.reshape(b, k, d).to(torch.bfloat16).float()
    vals = torch.where(in_block[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    out = torch.zeros((total_rows, d), dtype=torch.float32, device=g.device)
    return out.index_add_(0, safe.reshape(-1), vals.reshape(-1, d))


def _grad_lib() -> ctypes.CDLL:
    lib = _build.load("table_grad")
    if not getattr(lib, "_typed", False):
        for fn in (lib.table_grad, lib.table_grad_bmajor):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.table_grad_error_string.argtypes = [ctypes.c_int]
        lib.table_grad_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


GRAD_KERNEL_DIMS = tuple(range(8, 129, 8))  # the embed widths table_grad.cu is built for
# Each tile's id scan is split over a cluster of C CTAs (table_grad.cu). C
# doubles, up to the portable cluster size, while each CTA keeps at least
# CLUSTER_IDS ids to scan and the grid stays within CLUSTER_MAX_CTAS (four
# CTAs per SM of an H100, 132 SMs; the kernel keeps two resident on each).
# Measured on the H100 at B = 8192 (PERF.md, section 6: K2 at each C), this picks the
# fastest C at the company shape (4) and at R = 65,536 (1); at the notice
# shape it picks 2, which costs 3-4% against C = 1 on the bench's ids and
# saves a quarter where one row takes all of a feature's ids.
MAX_CLUSTER = 8
CLUSTER_IDS = 2048
CLUSTER_MAX_CTAS = 4 * 132


def table_grad_launch_shape(b: int, total_rows: int) -> tuple[int, int]:
    """(C, grid CTAs) of the table-gradient kernel for a batch of ``b`` ids
    per feature and a table of ``total_rows`` rows: a pure function of the
    shape, so two calls at one shape sum in one order and give the same
    bits."""
    tiles = total_rows // TILE_ROWS
    c = 1
    while c < MAX_CLUSTER and b >= 2 * c * CLUSTER_IDS and 2 * c * tiles <= CLUSTER_MAX_CTAS:
        c *= 2
    return c, c * tiles


def _table_grad_launch(rows: torch.Tensor, g: torch.Tensor, tile_feature: torch.Tensor, *, transposed: bool,
                       cluster: int | None = None):
    """Checks the inputs; for CUDA tensors launches the kernel (the [D, R]
    store when ``transposed``) with ``cluster`` CTAs per tile (default: the
    shape's, :func:`table_grad_launch_shape`) and returns its output, for
    CPU tensors returns None."""
    what = "dense_table_grad_bmajor" if transposed else "dense_table_grad"
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be [B, K] int32, got {tuple(rows.shape)} {rows.dtype}")
    b, k = rows.shape
    if g.dim() != 3 or g.shape[:2] != (b, k):
        raise ValueError(f"g must be [{b}, {k}, D], got {tuple(g.shape)}")
    if tile_feature.dim() != 1 or tile_feature.dtype != torch.int32:
        raise ValueError(f"tile_feature must be [R/128] int32, got {tuple(tile_feature.shape)} {tile_feature.dtype}")
    if not (rows.device == g.device == tile_feature.device):
        raise ValueError(f"rows, g and tile_feature must share a device, got {rows.device}, {g.device}, {tile_feature.device}")
    if g.device.type == "cpu":
        return None
    if g.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {g.device}")
    d = g.shape[2]
    if d not in GRAD_KERNEL_DIMS:
        raise ValueError(f"the table gradient kernel takes D a multiple of 8 up to 128, got {d}")
    total_rows = TILE_ROWS * tile_feature.shape[0]
    gb = g.to(torch.bfloat16).contiguous()
    rows = rows.contiguous()
    tile_feature = tile_feature.contiguous()
    out = torch.empty((d, total_rows) if transposed else (total_rows, d), dtype=torch.float32, device=g.device)
    if gb.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned for the kernel's vector loads")
    if cluster is None:
        cluster, _ = table_grad_launch_shape(b, total_rows)
    lib = _grad_lib()
    launch = lib.table_grad_bmajor if transposed else lib.table_grad
    with torch.cuda.device(g.device):
        err = launch(
            rows.data_ptr(), gb.data_ptr(), tile_feature.data_ptr(), out.data_ptr(),
            b, k, d, total_rows, cluster, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.table_grad_error_string(err).decode()}")
    return out


def dense_table_grad(
    rows: torch.Tensor, g: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """The dense table gradient: (rows [B, K] absolute int32 rows, g
    [B, K, D] cotangent, rounded to bf16 as on the TPU, tile_feature
    [R/128] int32) -> [R, D] f32; see :func:`dense_table_grad_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. Its sums run in a
    fixed order, so two calls give the same bits. ``launches`` counts the
    kernel's launches."""
    out = _table_grad_launch(rows, g, tile_feature, transposed=False)
    if out is None:
        return dense_table_grad_plain(rows, g, tile_feature)
    dense_table_grad.launches += 1
    return out


dense_table_grad.launches = 0


def dense_table_grad_bmajor_plain(
    rows: torch.Tensor, g: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """:func:`dense_table_grad_plain` transposed: dT^T [D, R] f32."""
    return dense_table_grad_plain(rows, g, tile_feature).t().contiguous()


def dense_table_grad_bmajor(
    rows: torch.Tensor, g: torch.Tensor, tile_feature: torch.Tensor
) -> torch.Tensor:
    """K3: the dense table gradient in the [D, R] layout the reference's
    ``dense_table_grad_bmajor`` returns, from the native [B, K, D]
    cotangent; see :func:`dense_table_grad_bmajor_plain`. The kernel is
    :func:`dense_table_grad`'s with a transposed store, so its output is
    that function's transposed, bit for bit.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise. ``launches`` counts the kernel's
    launches."""
    out = _table_grad_launch(rows, g, tile_feature, transposed=True)
    if out is None:
        return dense_table_grad_bmajor_plain(rows, g, tile_feature)
    dense_table_grad_bmajor.launches += 1
    return out


dense_table_grad_bmajor.launches = 0


# -- differentiable lookups --------------------------------------------------------


class _OneHotLookup(torch.autograd.Function):
    """Forward: the one-hot lookup kernel (bf16 out). Backward: the dense
    table gradient, cast back to the table's dtype (the reference's
    ``make_onehot_lookup`` custom VJP, embedding_grad.py:464-486)."""

    @staticmethod
    def forward(ctx, table, rows, tile_feature):
        ctx.save_for_backward(rows, tile_feature)
        ctx.table_dtype = table.dtype
        return dense_table_lookup(table, rows, tile_feature)

    @staticmethod
    def backward(ctx, g):
        rows, tile_feature = ctx.saved_tensors
        return dense_table_grad(rows, g, tile_feature).to(ctx.table_dtype), None, None


class _DenseGradLookup(torch.autograd.Function):
    """Forward: a plain row gather in the table's dtype. Backward: the dense
    table gradient kernel in place of the scatter (the reference's
    ``make_dense_grad_lookup``, embedding_grad.py:495-518)."""

    @staticmethod
    def forward(ctx, table, rows, tile_feature):
        ctx.save_for_backward(rows, tile_feature)
        return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        rows, tile_feature = ctx.saved_tensors
        return dense_table_grad(rows, g, tile_feature).to(g.dtype), None, None


def _layout_lookup(fn, total_rows: int, tile_feature):
    tf = np.asarray(tile_feature, np.int32)
    if tf.shape != (total_rows // TILE_ROWS,) or total_rows % TILE_ROWS:
        raise ValueError(
            f"tile_feature needs one entry per {TILE_ROWS}-row tile of {total_rows} rows, "
            f"got {tf.shape[0]}"
        )
    on_device: dict[torch.device, torch.Tensor] = {}

    def lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        t = on_device.get(table.device)
        if t is None:
            # a normal tensor even when the first call is an evaluation's:
            # an inference tensor cannot be saved for a later step's backward
            with torch.inference_mode(False):
                t = on_device[table.device] = torch.from_numpy(tf).to(table.device, copy=True)
        return fn.apply(table, rows.to(torch.int32).contiguous(), t)

    return lookup


def make_onehot_lookup(total_rows: int, tile_feature):
    """Differentiable lookup (table [R, D], rows [B, K]) -> [B, K, D] bf16
    for a fixed table layout: forward :func:`dense_table_lookup`, backward
    :func:`dense_table_grad`. The tile map is copied to each device once.
    Clamp semantics live in the caller's row mapping
    (models/embedding.absolute_rows)."""
    return _layout_lookup(_OneHotLookup, total_rows, tile_feature)


def make_dense_grad_lookup(total_rows: int, tile_feature):
    """Differentiable lookup (table [R, D], rows [B, K]) -> [B, K, D] in the
    table's dtype: a plain gather forward whose backward is
    :func:`dense_table_grad` instead of a scatter."""
    return _layout_lookup(_DenseGradLookup, total_rows, tile_feature)
