"""The int8 index scan's product (``csrc/int8_scan.cu``).

``S[q, c] = scales[c] * sum_d queries[q, d] * values[c, d]`` in float32: the
bf16 queries [Q, D] against the int8 rows [C, D] of an index chunk, each row
scaled by its float32 scale [C], into the [Q, C] float32 score block that
``ops/chunk_topk`` takes. An int8 value and a bf16 query are exact in bf16,
so every product is exact in float32 and only the order of the float32 sum
can differ between two ways of forming it.

* :func:`int8_scan_plain` is the plain version, in PyTorch: the rows widened
  to float32 and a float32 product, then the scale (the port's scan before
  the kernel, and the CPU's).
* :func:`int8_scan` runs it for CPU tensors, and on CUDA launches the
  kernel: each int8 row read once and widened to bf16 on chip, wgmma
  products with float32 sums, the scale in the epilogue, the block written in
  full 128-byte lines; on the current stream, with no host sync. It replaces
  no TPU kernel: the reference left the int8 -> bf16 convert to XLA, fused
  into its matmul. The block's row stride is C rounded up to a multiple of
  4, so that every row starts 16-byte aligned for the kernel's stores; the
  result is a view of its first C columns. ``launches`` counts its
  launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from jodalrob_twotower_torch.ops import _build

MAX_D = 1024  # the kernel's deepest rows (csrc/int8_scan.cu kMaxD)


def int8_scan_plain(queries: torch.Tensor, values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(queries @ values.T) * scales with the rows widened to float32: [Q, C] float32."""
    return (queries.float() @ values.float().T).mul_(scales[None, :])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_scan")
    if not getattr(lib, "_typed", False):
        lib.int8_scan.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        lib.int8_scan.restype = ctypes.c_int
        lib.int8_scan_error_string.argtypes = [ctypes.c_int]
        lib.int8_scan_error_string.restype = ctypes.c_char_p
        if lib.int8_scan_max_d() != MAX_D:
            raise RuntimeError(f"csrc/int8_scan.cu's largest depth is {lib.int8_scan_max_d()}, the wrapper's {MAX_D}")
        lib._typed = True
    return lib


def _check(queries: torch.Tensor, values: torch.Tensor, scales: torch.Tensor) -> None:
    if queries.dim() != 2 or values.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"queries [Q, D], values [C, D] and scales [C] expected, got {tuple(queries.shape)}, "
                         f"{tuple(values.shape)}, {tuple(scales.shape)}")
    if queries.dtype != torch.bfloat16 or values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"queries must be bfloat16, values int8 and scales float32, got {queries.dtype}, "
                         f"{values.dtype}, {scales.dtype}")
    if queries.shape[1] != values.shape[1] or scales.shape[0] != values.shape[0]:
        raise ValueError(f"queries of depth {queries.shape[1]} against values {tuple(values.shape)} and "
                         f"{scales.shape[0]} scales")
    if not queries.device == values.device == scales.device:
        raise ValueError(f"tensors on {queries.device}, {values.device}, {scales.device}")
    if not (queries.is_contiguous() and values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("queries, values and scales must be contiguous")


def int8_scan(queries: torch.Tensor, values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The scaled score block [Q, C] float32; see :func:`int8_scan_plain`
    for the function. CPU tensors take the plain version. CUDA tensors
    launch the kernel, or raise; D is at most ``MAX_D`` there."""
    _check(queries, values, scales)
    if queries.device.type == "cpu":
        return int8_scan_plain(queries, values, scales)
    (q, d), c = queries.shape, values.shape[0]
    if d > MAX_D:
        raise ValueError(f"the int8 scan kernel takes rows of at most {MAX_D} values, got {d}")
    ld = -(-c // 4) * 4
    out = torch.empty((q, ld), dtype=torch.float32, device=queries.device)
    if q and c:
        lib = _lib()
        with torch.cuda.device(queries.device):
            err = lib.int8_scan(queries.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(), q, c, d,
                                ld, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8_scan launch failed: {lib.int8_scan_error_string(err).decode()}")
        int8_scan.launches += 1
    return out if ld == c else out[:, :c]


int8_scan.launches = 0
