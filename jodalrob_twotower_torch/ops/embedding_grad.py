"""One-hot embedding lookup on the unified table (port of the forward half of
``jodalrob_twotower_tpu/ops/embedding_grad.py``).

``dense_table_lookup`` is the wrapper of the hand-written CUDA kernel
``csrc/onehot_lookup.cu``, which replaces the TPU kernel
``embedding_grad.py:358 _lookup_kernel``. The TPU computed the lookup as a
one-hot matmul because its row DMAs were slow; the Hopper kernel is a direct
row gather with the same result, emitted in the towers' ``[B, K, D]``
layout. ``dense_table_lookup_plain`` is the same function in plain PyTorch:
the CPU path and the reference the card's run is held against.

The gradient kernels of this module (the dense-vocab table gradient) arrive
with the training slice of the port.
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
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "the one-hot lookup kernel has no backward yet (it arrives with the "
            "training slice); call it under torch.no_grad() or inference_mode()"
        )
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


def make_onehot_lookup(total_rows: int, tile_feature):
    """Lookup (table [R, D], rows [B, K]) -> [B, K, D] bf16 through
    :func:`dense_table_lookup`, for a fixed table layout. The tile map is
    copied to each device once. Clamp semantics live in the caller's row
    mapping (models/embedding.absolute_rows)."""
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
            t = on_device[table.device] = torch.from_numpy(tf).to(table.device)
        return dense_table_lookup(table, rows.to(torch.int32).contiguous(), t)

    return lookup
