"""Fused in-batch-negative logits: the CE loss and the in-batch statistics
without the [B, B] matrix (port of ``jodalrob_twotower_tpu/ops/fused_logits.py``).

Per row i and column j of S = (N/tau) C^T the loss and the metrics need

  row_lse_i = logsumexp_j S_ij    col_lse_j = logsumexp_i S_ij
  row_sum_i = sum_j S_ij          col_sum_j = sum_i S_ij
  diag_i    = S_ii                rank_i    = #{j != i : S_ij > S_ii}

The loss without label smoothing needs only the lse values and the diagonal;
its gradient contracts dL/dS = (1/2B)[P_row + P_col - 2(1-eps) delta -
2 eps/B] against C and N. Four hand-written CUDA kernels compute these
without writing S, each from N/tau and C in bf16 with f32 accumulation, as
the TPU kernels do:

* :func:`fused_lean_lse` -> ``csrc/fused_ce_fwd.cu``: the lean forward,
  replacing ``fused_logits.py:241 _fwd_lean_kernel`` and ``:280
  _fwd_lean_nomax_kernel`` (B <= 8192) and ``:387 _fwd_lean_blocked_kernel``
  (8192 < B <= 65536);
* :func:`fused_ce_bwd` -> ``csrc/fused_ce_bwd.cu``: the backward, replacing
  ``:819 _bwd_kernel`` (B <= 8192) and ``:707/:724 _bwd_dn/dc_blocked_kernel``
  (beyond);
* :func:`same_tile_diag` -> ``csrc/fused_stats.cu``: S_ii from the same tile
  product the statistics sweep runs, replacing ``:518 _diag_mxu_kernel``;
* :func:`fused_stats_sweep` -> ``csrc/fused_stats.cu``: every statistic
  above, replacing ``:95 _fwd_kernel`` (B <= 8192) and ``:553
  _fwd_stats_blocked_kernel`` (beyond).

The TPU needed separate blocked kernels past B = 8192 because all of C had
to fit its 16 MB VMEM; these kernels stream C through shared memory at every
B, so one kernel serves both ranges. Each has a plain PyTorch version beside
it (``*_plain``), taken only for CPU tensors; a CUDA tensor launches the
kernel or raises. :func:`fused_bidirectional_ce` wraps the loss in one
``torch.autograd.Function``; :func:`fused_stats` and
:func:`fused_in_batch_metrics` serve the evaluation step.

Dispatch follows the reference's envelopes: B % 128 == 0 and B <= 8192, or
B % 1024 == 0 and 8192 < B <= 65536, with D % 128 == 0, take the kernels
(:func:`ce_route`: the lean forward without label smoothing, the statistics
forward with it; the backward either way). The CUDA kernels take any such
D: with wgmma and TMA up to D = 512 (``csrc/wgmma.cuh``; the lean forward
and the statistics sweep share one warpgroup sweep, ``csrc/softmax_sweep.cuh``)
and with mma.sync in 128-deep chunks past it (``csrc/tile_mma.cuh``). Shapes
outside the envelopes take the materialized float32 path, as ``_ce_primal``/``_ce_bwd``/
``_stats_xla`` do in the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from jodalrob_twotower_torch.ops import _build

_BM = 128  # the reference's row-block height: B must be a multiple
_MAX_B = 8192  # the reference's single-kernel envelope
_MAX_B_BLOCKED = 65536  # the reference's col-blocked envelope (K7, K10)
_BN_BLOCKED = 1024
_NOMAX_MAX_ABS = 60.0  # |S| bound under which exp(S) cannot overflow f32
_KERNEL_CHUNK = 128  # the CUDA kernels' depth chunk: D must be a multiple
_KERNEL_ROWS = 64  # the CUDA kernels' row block


def _supported(b: int, d: int) -> bool:
    return b % _BM == 0 and b <= _MAX_B and d % 128 == 0


def _blocked_supported(b: int, d: int) -> bool:
    return _MAX_B < b <= _MAX_B_BLOCKED and b % _BN_BLOCKED == 0 and d % 128 == 0


def _in_kernel_envelope(b: int, d: int) -> bool:
    """Whether a batch of B columns of width D takes the kernels (the
    reference's envelopes)."""
    return _supported(b, d) or _blocked_supported(b, d)


def _shard_in_kernel_envelope(rows: int, b: int, d: int) -> bool:
    """Whether a block of ``rows`` rows against B columns of width D takes
    the kernels (the reference's ``_sharded_supported`` and, past B = 8192,
    its ``_blocked_supported``): the batch's envelope, with rows a multiple
    of 128 or at most 128. The CUDA kernels add their row block: rows (and
    so a mesh rank's row offset, rank x rows) a multiple of 64, which K8
    and the sweep need to find the diagonal in one tile. A block of 32 or
    96 rows, which the reference's kernels take, takes the materialized
    route here, on every device alike."""
    return _in_kernel_envelope(b, d) and (rows % _BM == 0 or rows <= _BM) and rows % _KERNEL_ROWS == 0


def ce_route(b: int, d: int, label_smoothing: float) -> str:
    """How the fused CE runs for a [B, D] batch: "kernel" (the lean forward
    and the backward), "stats" (the statistics forward, which label smoothing
    needs, and the backward), both as CUDA kernels on the card or their plain
    versions on the CPU; or "materialized" (float32 [B, B] logits, outside
    every envelope)."""
    if not _in_kernel_envelope(b, d):
        return "materialized"
    return "kernel" if label_smoothing == 0 else "stats"


# -- K6: the lean forward -------------------------------------------------------


def fused_lean_lse_plain(
    n_scaled: torch.Tensor, c: torch.Tensor, *, nomax: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_lse [rows], col_lse [B]) f32 of S = n_scaled c^T, from bf16
    operands; ``nomax`` takes the unshifted sums of exp. S and the sums are
    formed in float64 and rounded to f32 once, so the result is the
    correctly rounded value of the function: no f32 summation order, thread
    split or reduced-precision product of the backend moves it (the kernels'
    f32 sums lie within a few f32 ulps of it)."""
    s = n_scaled.to(torch.bfloat16).double() @ c.to(torch.bfloat16).double().T
    if nomax:
        es = torch.exp(s)
        return torch.log(es.sum(1)).float(), torch.log(es.sum(0)).float()
    return torch.logsumexp(s, 1).float(), torch.logsumexp(s, 0).float()


# The lean forward's split (csrc/fused_ce_fwd.cu): up to D = 512 a CTA's W
# consumer warpgroups hold NW columns of C each and stream 64-row tiles of N;
# the units (a block of their W NW columns against a row tile) are split
# evenly over one CTA per SM of an H100 SXM. NW is 128 for the unshifted form
# up to D = 256, else 64; W is 3 for the unshifted form at D = 128 and the
# shifted form up to D = 256, else 2.
LEAN_SMS = 132
LEAN_WGMMA_MAX_D = 512


class LeanLaunch(NamedTuple):
    ctas: int  # the grid
    sub_cols: int  # columns of C a row partial covers (NW; all of C past D = 512)
    block_cols: int  # columns of C a unit covers (W NW; all of C past D = 512)
    row_parts: int  # partials a row of N merges
    col_parts: int  # partials a column of C merges, at most
    workspace_floats: int  # 2 (row_parts rows + col_parts B): a (sum, max) pair each


def lean_lse_launch_shape(rows: int, b: int, d: int, nomax: bool) -> LeanLaunch:
    """The lean forward's grid and workspace for N [rows, D] against C
    [B, D] in the form ``nomax``: a pure function of the shape, so two calls
    at one shape sum in one order and give the same bits. Up to D = 512 CTA
    k takes units [k U / G, (k + 1) U / G) of the U = ceil(B / (W NW))
    (rows / 64) units, W consumer warpgroups, G = min(132, U); a column's
    partials come from the CTAs whose ranges meet its block. Past D = 512
    one CTA per 64 rows, each with a partial per column."""
    if d > LEAN_WGMMA_MAX_D:
        blocks = rows // _KERNEL_ROWS
        return LeanLaunch(blocks, b, b, 0, blocks, 2 * blocks * b)
    nw = 128 if nomax and d <= 256 else 64
    consumers = 3 if (nomax and d == 128) or (not nomax and d <= 256) else 2
    n_x, n_y = -(-b // (consumers * nw)), rows // _KERNEL_ROWS
    units = n_x * n_y
    ctas = min(LEAN_SMS, units)

    def cta_of_unit(u: int) -> int:
        return ((u + 1) * ctas - 1) // units

    col_parts = max(cta_of_unit((x + 1) * n_y - 1) - cta_of_unit(x * n_y) + 1 for x in range(n_x))
    row_parts = -(-b // nw)
    return LeanLaunch(ctas, nw, consumers * nw, row_parts, col_parts, 2 * (row_parts * rows + col_parts * b))


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce_fwd")
    if not getattr(lib, "_typed", False):
        lib.fused_lean_lse.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.fused_lean_lse.restype = ctypes.c_int
        lib.fused_lean_lse_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_lean_lse_smem_bytes.restype = ctypes.c_int
        lib.fused_lean_lse_error_string.argtypes = [ctypes.c_int]
        lib.fused_lean_lse_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce_bwd")
    if not getattr(lib, "_typed", False):
        lib.fused_ce_bwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.fused_ce_bwd.restype = ctypes.c_int
        lib.fused_ce_bwd_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_ce_bwd_smem_bytes.restype = ctypes.c_int
        lib.fused_ce_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_ce_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(n: torch.Tensor, c: torch.Tensor, what: str) -> None:
    if n.dim() != 2 or c.dim() != 2 or n.shape[1] != c.shape[1]:
        raise ValueError(f"{what}: n [rows, D] and c [B, D] needed, got {tuple(n.shape)}, {tuple(c.shape)}")
    if n.device != c.device:
        raise ValueError(f"{what}: n and c must share a device, got {n.device}, {c.device}")


def _check_offset(rows: int, b: int, row_offset: int, what: str) -> None:
    if not 0 <= row_offset <= b - rows:
        raise ValueError(f"{what}: row_offset {row_offset} places rows outside [0, {b})")


def _check_kernel_operands(n: torch.Tensor, c: torch.Tensor, what: str) -> None:
    if n.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {n.device}")
    rows, d = n.shape
    b = c.shape[0]
    if d % _KERNEL_CHUNK or rows % _KERNEL_ROWS or b % _KERNEL_ROWS or d == 0 or rows == 0 or b == 0:
        raise ValueError(
            f"{what}: the kernel takes D a multiple of {_KERNEL_CHUNK} and rows, B multiples "
            f"of {_KERNEL_ROWS}, got n {tuple(n.shape)}, c {tuple(c.shape)}"
        )
    for t in (n, c):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: n and c must be contiguous, 16-byte aligned bfloat16")


def fused_lean_lse(
    n_scaled: torch.Tensor, c: torch.Tensor, *, nomax: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (and K7 past B = 8192): (row_lse [rows], col_lse [B]) of
    S = bf16(n_scaled) bf16(c)^T without writing S (see
    :func:`fused_lean_lse_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream or raise. The partials
    take a workspace of :func:`lean_lse_launch_shape`'s size, at rows = B and
    D = 128 unshifted (shifted): 4.4 (8.3) MiB at B = 8192, 257 (513) MiB at
    65536. ``launches`` counts the kernel's launches."""
    _check_operands(n_scaled, c, "fused_lean_lse")
    if n_scaled.device.type == "cpu":
        return fused_lean_lse_plain(n_scaled, c, nomax=nomax)
    nb = n_scaled.to(torch.bfloat16).contiguous()
    cb = c.to(torch.bfloat16).contiguous()
    _check_kernel_operands(nb, cb, "fused_lean_lse")
    rows, d = nb.shape
    b = cb.shape[0]
    row_lse = torch.empty(rows, dtype=torch.float32, device=nb.device)
    col_lse = torch.empty(b, dtype=torch.float32, device=nb.device)
    shape = lean_lse_launch_shape(rows, b, d, nomax)
    workspace = torch.empty(shape.workspace_floats, dtype=torch.float32, device=nb.device)
    lib = _fwd_lib()
    with torch.cuda.device(nb.device):
        err = lib.fused_lean_lse(
            nb.data_ptr(), cb.data_ptr(), row_lse.data_ptr(), col_lse.data_ptr(),
            workspace.data_ptr(), rows, b, d, int(nomax), shape.ctas, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_lean_lse launch failed: {lib.fused_lean_lse_error_string(err).decode()}")
    fused_lean_lse.launches += 1
    return row_lse, col_lse


fused_lean_lse.launches = 0


# -- K11: the backward -----------------------------------------------------------


def _bwd_constants(b: int, eps: float) -> tuple[float, float, float]:
    """The f32 constants 0.5/B, 2(1-eps) and 2 eps/B as the reference's
    kernel forms them (Python doubles rounded once, then f32 arithmetic)."""
    e = torch.tensor(eps, dtype=torch.float32)
    inv2b = float(torch.tensor(0.5 / b, dtype=torch.float32))
    diag_coef = float(2.0 * (1.0 - e))
    smooth = float((2.0 * e) / b)
    return inv2b, diag_coef, smooth


def fused_ce_bwd_plain(
    n_scaled: torch.Tensor,
    c: torch.Tensor,
    row_lse: torch.Tensor,
    col_lse: torch.Tensor,
    label_smoothing: float = 0.0,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dn [rows, D], dc [B, D]) f32: A = bf16((1/2B)[exp(S - row_lse) +
    exp(S - col_lse) - 2(1-eps) delta - 2 eps/B]) with delta at column
    row + row_offset, dn = A c, dc = A^T n (over n's rows), from bf16
    operands with f32 accumulation."""
    nb = n_scaled.to(torch.bfloat16).float()
    cb = c.to(torch.bfloat16).float()
    rows, b = nb.shape[0], cb.shape[0]
    inv2b, diag_coef, smooth = _bwd_constants(b, label_smoothing)
    s = nb @ cb.T
    x = torch.exp(s - row_lse[:, None]) + torch.exp(s - col_lse[None, :])
    idx = torch.arange(rows, device=s.device)
    x[idx, idx + row_offset] -= diag_coef
    a = (inv2b * (x - smooth)).to(torch.bfloat16).float()
    return a @ cb, a.T @ nb


def fused_ce_bwd(
    n_scaled: torch.Tensor,
    c: torch.Tensor,
    row_lse: torch.Tensor,
    col_lse: torch.Tensor,
    label_smoothing: float = 0.0,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K11 (and K10 past B = 8192): see :func:`fused_ce_bwd_plain` for the
    function. CPU tensors take the plain version; CUDA tensors launch the
    kernel (a dn sweep and a dc sweep in one grid, no atomics; S formed once
    per row block and column tile in each sweep up to D = 512) on the current
    stream or raise. ``launches`` counts the kernel's launches."""
    _check_operands(n_scaled, c, "fused_ce_bwd")
    rows, b = n_scaled.shape[0], c.shape[0]
    if row_lse.shape != (rows,) or col_lse.shape != (b,):
        raise ValueError(f"fused_ce_bwd: row_lse [{rows}] and col_lse [{b}] needed")
    _check_offset(rows, b, row_offset, "fused_ce_bwd")
    if n_scaled.device.type == "cpu":
        return fused_ce_bwd_plain(n_scaled, c, row_lse, col_lse, label_smoothing, row_offset)
    nb = n_scaled.to(torch.bfloat16).contiguous()
    cb = c.to(torch.bfloat16).contiguous()
    _check_kernel_operands(nb, cb, "fused_ce_bwd")
    rl = row_lse.to(torch.float32).contiguous()
    cl = col_lse.to(torch.float32).contiguous()
    d = nb.shape[1]
    dn = torch.empty((rows, d), dtype=torch.float32, device=nb.device)
    dc = torch.empty((b, d), dtype=torch.float32, device=nb.device)
    inv2b, diag_coef, smooth = _bwd_constants(b, label_smoothing)
    lib = _bwd_lib()
    with torch.cuda.device(nb.device):
        err = lib.fused_ce_bwd(
            nb.data_ptr(), cb.data_ptr(), rl.data_ptr(), cl.data_ptr(), dn.data_ptr(),
            dc.data_ptr(), rows, b, d, inv2b, diag_coef, smooth, row_offset,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_ce_bwd launch failed: {lib.fused_ce_bwd_error_string(err).decode()}")
    fused_ce_bwd.launches += 1
    return dn, dc


fused_ce_bwd.launches = 0


# -- K8 and K5/K9: the diagonal and the statistics sweep -------------------------


class StatsLaunch(NamedTuple):
    ctas: int  # the sweep's grid
    block_cols: int  # columns of C a unit covers (W 64-column slices; all of C past D = 512)
    row_parts: int  # partials a row of N merges (one per 64-column slice; 0 past D = 512)
    col_parts: int  # partials a column of C merges, at most
    workspace_floats: int


def stats_launch_shape(rows: int, b: int, d: int) -> StatsLaunch:
    """The statistics sweep's grid and workspace for N [rows, D] against C
    [B, D]: a pure function of the shape, so two calls at one shape sum in
    one order and give the same bits. Up to D = 512 it is the lean forward's
    shifted split (csrc/softmax_sweep.cuh): W 64-column consumer
    warpgroups (W = 3 up to D = 256, else 2), CTA k taking units [k U / G,
    (k + 1) U / G) of the U = ceil(B / 64 W) (rows / 64) units, G =
    min(132, U); a row merges one float4 partial (sum of exp, max, plain
    sum, rank) per 64 columns, a column one per CTA whose range meets its
    block. Past D = 512 one block per 64 rows, with three [rows / 64, B]
    planes of column partials."""
    if d > LEAN_WGMMA_MAX_D:
        blocks = rows // _KERNEL_ROWS
        return StatsLaunch(blocks, b, 0, blocks, 3 * blocks * b)
    lean = lean_lse_launch_shape(rows, b, d, nomax=False)
    return StatsLaunch(lean.ctas, lean.block_cols, lean.row_parts, lean.col_parts,
                       4 * (lean.row_parts * rows + lean.col_parts * b))


def _stats_lib() -> ctypes.CDLL:
    lib = _build.load("fused_stats")
    if not getattr(lib, "_typed", False):
        lib.same_tile_diag.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.same_tile_diag.restype = ctypes.c_int
        lib.fused_stats_sweep.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.fused_stats_sweep.restype = ctypes.c_int
        lib.fused_stats_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_stats_smem_bytes.restype = ctypes.c_int
        lib.fused_stats_error_string.argtypes = [ctypes.c_int]
        lib.fused_stats_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_stats_kernel_operands(nb: torch.Tensor, cb: torch.Tensor, row_offset: int, what: str) -> None:
    _check_kernel_operands(nb, cb, what)
    if row_offset % _KERNEL_ROWS:
        raise ValueError(
            f"{what}: the kernel takes a row_offset that is a multiple of {_KERNEL_ROWS} (so the "
            f"diagonal of a row block is one tile of the sweep), got {row_offset}"
        )


def same_tile_diag_plain(n_scaled: torch.Tensor, c: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """diag [rows] f32: S[i, i + row_offset] of S = bf16(n_scaled) bf16(c)^T,
    as a row sum of the bf16 operands' products."""
    rows = n_scaled.shape[0]
    nb = n_scaled.to(torch.bfloat16).float()
    cb = c[row_offset : row_offset + rows].to(torch.bfloat16).float()
    return (nb * cb).sum(1)


def same_tile_diag(n_scaled: torch.Tensor, c: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """K8: S[i, i + row_offset] (see :func:`same_tile_diag_plain`). On CUDA
    it comes from the same tile product as the statistics sweep, so it is
    bit for bit the value S_ii has there (``csrc/fused_stats.cu``); rows,
    B and row_offset must be multiples of 64. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. ``launches`` counts
    the kernel's launches."""
    _check_operands(n_scaled, c, "same_tile_diag")
    rows, b = n_scaled.shape[0], c.shape[0]
    _check_offset(rows, b, row_offset, "same_tile_diag")
    if n_scaled.device.type == "cpu":
        return same_tile_diag_plain(n_scaled, c, row_offset)
    nb = n_scaled.to(torch.bfloat16).contiguous()
    cb = c.to(torch.bfloat16).contiguous()
    _check_stats_kernel_operands(nb, cb, row_offset, "same_tile_diag")
    diag = torch.empty(rows, dtype=torch.float32, device=nb.device)
    lib = _stats_lib()
    with torch.cuda.device(nb.device):
        err = lib.same_tile_diag(
            nb.data_ptr(), cb.data_ptr(), diag.data_ptr(), rows, b, nb.shape[1], row_offset,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"same_tile_diag launch failed: {lib.fused_stats_error_string(err).decode()}")
    same_tile_diag.launches += 1
    return diag


same_tile_diag.launches = 0


def _stats_from_scores(
    s: torch.Tensor, row_offset: int, diag: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_stats [rows, 4] = lse, sum, diag, rank; col_stats [2, B] = lse,
    sum) of a materialized S. The diagonal sits at column row + row_offset;
    ``diag`` (default: S's own) is what rank compares against, and its
    column is left out by index."""
    rows = s.shape[0]
    idx = torch.arange(rows, device=s.device)
    if diag is None:
        diag = s[idx, idx + row_offset]
    above = s > diag[:, None]
    above[idx, idx + row_offset] = False
    row_stats = torch.stack([torch.logsumexp(s, 1), s.sum(1), diag, above.sum(1).float()], 1)
    return row_stats, torch.stack([torch.logsumexp(s, 0), s.sum(0)])


def _bf16_scores(n_scaled: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return n_scaled.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T


def fused_stats_sweep_plain(
    n_scaled: torch.Tensor, c: torch.Tensor, diag: torch.Tensor, row_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_stats [rows, 4] = lse, sum, diag, rank; col_stats [2, B] = lse,
    sum over n's rows) of S = bf16(n_scaled) bf16(c)^T with f32 sums, rank
    counting the columns other than row + row_offset whose S exceeds
    ``diag``."""
    return _stats_from_scores(_bf16_scores(n_scaled, c), row_offset, diag.float())


def fused_stats_sweep(
    n_scaled: torch.Tensor, c: torch.Tensor, diag: torch.Tensor, row_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (and K9 past B = 8192): see :func:`fused_stats_sweep_plain` for the
    function; ``diag`` comes from :func:`same_tile_diag`. CPU tensors take
    the plain version; CUDA tensors launch the sweep and its merge on the
    current stream or raise. The partials take a workspace of
    :func:`stats_launch_shape`'s size: at rows = B and D = 128, 16.6 MiB at
    B = 8192, 1026 MiB at 65536. ``launches`` counts the kernel's launches."""
    _check_operands(n_scaled, c, "fused_stats_sweep")
    rows, b = n_scaled.shape[0], c.shape[0]
    if diag.shape != (rows,):
        raise ValueError(f"fused_stats_sweep: diag [{rows}] needed, got {tuple(diag.shape)}")
    _check_offset(rows, b, row_offset, "fused_stats_sweep")
    if n_scaled.device.type == "cpu":
        return fused_stats_sweep_plain(n_scaled, c, diag, row_offset)
    nb = n_scaled.to(torch.bfloat16).contiguous()
    cb = c.to(torch.bfloat16).contiguous()
    _check_stats_kernel_operands(nb, cb, row_offset, "fused_stats_sweep")
    dg = diag.to(torch.float32).contiguous()
    row_stats = torch.empty((rows, 4), dtype=torch.float32, device=nb.device)
    col_stats = torch.empty((2, b), dtype=torch.float32, device=nb.device)
    shape = stats_launch_shape(rows, b, nb.shape[1])
    workspace = torch.empty(shape.workspace_floats, dtype=torch.float32, device=nb.device)
    lib = _stats_lib()
    with torch.cuda.device(nb.device):
        err = lib.fused_stats_sweep(
            nb.data_ptr(), cb.data_ptr(), dg.data_ptr(), row_stats.data_ptr(), col_stats.data_ptr(),
            workspace.data_ptr(), rows, b, nb.shape[1], row_offset, shape.ctas,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_stats_sweep launch failed: {lib.fused_stats_error_string(err).decode()}")
    fused_stats_sweep.launches += 1
    return row_stats, col_stats


fused_stats_sweep.launches = 0


class FusedStats(NamedTuple):
    """Per-row and per-column statistics of the similarity matrix."""

    row_lse: torch.Tensor
    row_sum: torch.Tensor
    diag: torch.Tensor
    rank: torch.Tensor
    col_lse: torch.Tensor
    col_sum: torch.Tensor


def _unpack(row_stats: torch.Tensor, col_stats: torch.Tensor) -> FusedStats:
    return FusedStats(row_stats[:, 0], row_stats[:, 1], row_stats[:, 2], row_stats[:, 3], col_stats[0], col_stats[1])


def fused_stats(n: torch.Tensor, c: torch.Tensor, *, temperature: float = 1.0) -> FusedStats:
    """Every statistic of S = (n/tau) c^T for aligned [B, D] pairs without
    materializing S (reference ``fused_stats``, fused_logits.py:201-233).
    Inside the kernels' envelope: on CUDA, K8 then the sweep (K5, or K9 past
    B = 8192); on the CPU their plain version. Outside it: the materialized
    float32 statistics."""
    return _unpack(*fused_stats_rows(n.float() / temperature, c.float(), 0))


def fused_stats_rows(n_scaled: torch.Tensor, c: torch.Tensor, row_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_stats [rows, 4], col_stats [2, B]) of S = n_scaled c^T for a
    block of rows whose diagonal sits at column row + ``row_offset`` (the
    whole batch at 0, a mesh rank's block against the gathered batch
    otherwise). Inside the kernels' envelope: K8 then the sweep on CUDA,
    their plain version on the CPU; outside it, float32 statistics of the
    materialized block."""
    rows, b, d = n_scaled.shape[0], c.shape[0], c.shape[1]
    if not _shard_in_kernel_envelope(rows, b, d):
        return _stats_from_scores(n_scaled @ c.T, row_offset)
    if not n_scaled.is_cuda:
        # the diagonal from the same S the sweep's plain version makes, so
        # that rank compares like with like on the CPU
        return _stats_from_scores(_bf16_scores(n_scaled, c), row_offset)
    nb, cb = n_scaled.to(torch.bfloat16), c.to(torch.bfloat16)
    return fused_stats_sweep(nb, cb, same_tile_diag(nb, cb, row_offset), row_offset)


def fused_in_batch_metrics(
    n: torch.Tensor, c: torch.Tensor, *, temperature: float = 1.0, recall_ks: tuple[int, ...] = (5, 10)
) -> dict[str, torch.Tensor]:
    """The metric surface of ``train.metrics.in_batch_metrics`` from one
    :func:`fused_stats` pass (reference ``fused_in_batch_metrics``,
    fused_logits.py:1000-1033). Similarities are in S = n c^T / tau units,
    as the reference computes its metrics on the scaled matrix."""
    stats = fused_stats(n, c, temperature=temperature)
    b = stats.row_lse.shape[0]
    ranks = stats.rank
    neg_mean = (stats.row_sum - stats.diag) / max(b - 1, 1)
    metrics = {
        "accuracy": (ranks == 0).float().mean(),
        "mrr": (1.0 / (ranks + 1.0)).mean(),
        "auc": (1.0 - ranks / max(b - 1, 1)).mean(),
        "positive_similarity": stats.diag.mean(),
        "negative_similarity": neg_mean.mean(),
    }
    metrics["similarity_gap"] = metrics["positive_similarity"] - metrics["negative_similarity"]
    metrics["z_gap"] = metrics["similarity_gap"] / (metrics["negative_similarity"].abs() + 1e-8)
    for k in recall_ks:
        metrics[f"recall@{k}"] = (ranks < k).float().mean()
    return metrics


# -- the loss ---------------------------------------------------------------------


def _loss_from_stats(stats: FusedStats, label_smoothing: float) -> torch.Tensor:
    b = stats.row_lse.shape[0]
    eps = label_smoothing

    def side(lse, ssum):
        base = (1.0 - eps) * (lse - stats.diag)
        if eps:
            base = base + (eps / b) * (b * lse - ssum)
        return base.mean()

    return 0.5 * (side(stats.row_lse, stats.row_sum) + side(stats.col_lse, stats.col_sum))


def _bwd_materialized(n_scaled, c32, row_lse, col_lse, eps, row_offset: int = 0):
    """(dn, dc) of the float32 [rows, B] block whose diagonal sits at column
    row + ``row_offset``; dc sums over the block's rows only."""
    rows, b = n_scaled.shape[0], c32.shape[0]
    s = n_scaled @ c32.T
    eye = torch.zeros((rows, b), dtype=torch.float32, device=s.device)
    idx = torch.arange(rows, device=s.device)
    eye[idx, idx + row_offset] = 1.0
    a = (0.5 / b) * (
        torch.exp(s - row_lse[:, None]) + torch.exp(s - col_lse[None, :])
        - 2.0 * (1.0 - eps) * eye - 2.0 * eps / b
    )
    return a @ c32, a.T @ n_scaled


def _ce_primal(n, c, temperature, label_smoothing, max_abs_logit):
    """Loss and the (row_lse, col_lse) residuals (reference ``_ce_primal``,
    fused_logits.py:907-931). n/tau is formed in f32 before any bf16
    rounding. Without label smoothing the lean forward runs and the diagonal
    is the rowsum of the bf16-rounded operands, the values the kernel's S is
    made of; with it, the statistics forward (:func:`fused_stats`)."""
    n_scaled = n.float() / temperature
    b, d = n_scaled.shape
    if ce_route(b, d, label_smoothing) == "kernel":
        nomax = max_abs_logit is not None and max_abs_logit <= _NOMAX_MAX_ABS
        row_lse, col_lse = fused_lean_lse(n_scaled, c.float(), nomax=nomax)
        nb = n_scaled.to(torch.bfloat16).float()
        cb = c.float().to(torch.bfloat16).float()
        diag = (nb * cb).sum(1)
        loss = 0.5 * ((row_lse - diag).mean() + (col_lse - diag).mean())
        return loss, row_lse, col_lse
    stats = fused_stats(n, c, temperature=temperature)
    return _loss_from_stats(stats, label_smoothing), stats.row_lse, stats.col_lse


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, c, temperature, label_smoothing, max_abs_logit):
        loss, row_lse, col_lse = _ce_primal(n, c, temperature, label_smoothing, max_abs_logit)
        ctx.save_for_backward(n, c, row_lse, col_lse)
        ctx.temperature = temperature
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        """Reference ``_ce_bwd`` (fused_logits.py:961-989)."""
        n, c, row_lse, col_lse = ctx.saved_tensors
        tau, eps = ctx.temperature, ctx.label_smoothing
        n_scaled = n.float() / tau
        c32 = c.float()
        b, d = n_scaled.shape
        if ce_route(b, d, eps) == "materialized":
            dn_s, dc = _bwd_materialized(n_scaled, c32, row_lse, col_lse, eps)
        else:
            dn_s, dc = fused_ce_bwd(n_scaled, c32, row_lse, col_lse, eps)
        return (g * dn_s / tau).to(n.dtype), (g * dc).to(c.dtype), None, None, None


def fused_bidirectional_ce(
    n: torch.Tensor,
    c: torch.Tensor,
    temperature: float = 1.0,
    label_smoothing: float = 0.0,
    max_abs_logit: float | None = None,
) -> torch.Tensor:
    """Bidirectional in-batch-negatives CE without the [B, B] logits
    (reference ``fused_bidirectional_ce``). ``max_abs_logit``: a bound on
    |logits| the caller can prove (1/tau for L2-normalized inputs); within
    the f32 no-overflow margin the forward skips its max shift. ``None``
    always takes the shifted kernel."""
    return _FusedCE.apply(n, c, float(temperature), float(label_smoothing), max_abs_logit)


# -- the mesh-sharded CE ------------------------------------------------------------
#
# The reference's ``make_sharded_fused_ce`` (fused_logits.py:1066-1323): each
# mesh rank holds a block of b = B/n rows of both sides. The forward gathers
# the company side to [B, D] f32, runs the kernels on the rank's [b, D]
# notice rows against it (the diagonal at column row + r b), and merges the
# column logsumexp across ranks; the backward runs K11/K10 with the same row
# offset and reduce-scatters the column side's [B, D] partials back to each
# rank's rows. The loss is the global batch's, the same value on every rank:
# global in-batch negatives at any mesh size.


def _merge_col_lse(partial_lse: torch.Tensor, extra: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(global column lse, the sum over ranks of ``extra``) from per-rank
    partial lse over each rank's rows: one max-shifted merge (the
    reference's ``_merge_col_lse``), its sum of exponentials riding one
    all-reduce with ``extra``."""
    m = mesh.all_reduce_(partial_lse.clone(), "max")
    b = partial_lse.shape[0]
    summed = mesh.all_reduce_(torch.cat([torch.exp(partial_lse - m), extra.reshape(-1)]))
    return torch.log(summed[:b]) + m, summed[b:]


def _sharded_ce_primal(n, c_full, mesh, temperature, label_smoothing, max_abs_logit):
    """(loss, row_lse [b], col_lse [B]) of the rank's [b, D] notice rows
    against the gathered [B, D] company side (the reference's
    ``_sharded_ce_primal``)."""
    n_scaled = n.float() / temperature
    bl, d = n_scaled.shape
    b = c_full.shape[0]
    row0 = mesh.rank * bl
    eps = label_smoothing
    if eps == 0.0 and _shard_in_kernel_envelope(bl, b, d):
        nomax = max_abs_logit is not None and max_abs_logit <= _NOMAX_MAX_ABS
        row_lse, col_part = fused_lean_lse(n_scaled, c_full, nomax=nomax)
        # S_ii as a rowsum of the rank's aligned rows, from the bf16-rounded
        # operands the kernel's S is made of
        nb = n_scaled.to(torch.bfloat16).float()
        cb = c_full[row0 : row0 + bl].to(torch.bfloat16).float()
        diag = (nb * cb).sum(1)
        col_lse, sums = _merge_col_lse(col_part, torch.stack([(row_lse - diag).sum(), diag.sum()]), mesh)
        loss = 0.5 * (sums[0] / b + (col_lse.sum() - sums[1]) / b)
        return loss, row_lse, col_lse
    row_stats, col_stats = fused_stats_rows(n_scaled, c_full, row0)
    row_lse, row_sum, diag = row_stats[:, 0], row_stats[:, 1], row_stats[:, 2]
    row_base = (1.0 - eps) * (row_lse - diag)
    if eps:
        row_base = row_base + (eps / b) * (b * row_lse - row_sum)
    col_lse, merged = _merge_col_lse(col_stats[0], torch.cat([col_stats[1], torch.stack([row_base.sum(), diag.sum()])]),
                                     mesh)
    col_sum, row_total, diag_sum = merged[:b], merged[b], merged[b + 1]
    col_total = (1.0 - eps) * (col_lse.sum() - diag_sum)
    if eps:
        col_total = col_total + (eps / b) * (b * col_lse.sum() - col_sum.sum())
    return 0.5 * (row_total / b + col_total / b), row_lse, col_lse


class _ShardedFusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, c, mesh, temperature, label_smoothing, max_abs_logit):
        c_full = mesh.all_gather_rows(c.float())
        loss, row_lse, col_lse = _sharded_ce_primal(n, c_full, mesh, temperature, label_smoothing, max_abs_logit)
        ctx.save_for_backward(n, c_full, row_lse, col_lse)
        ctx.mesh, ctx.temperature, ctx.label_smoothing, ctx.c_dtype = mesh, temperature, label_smoothing, c.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        """The reference's ``_sharded_ce_grads_local``: the rank's dn and
        its block of dc, summed over every rank's rows."""
        n, c_full, row_lse, col_lse = ctx.saved_tensors
        mesh, tau, eps = ctx.mesh, ctx.temperature, ctx.label_smoothing
        n_scaled = n.float() / tau
        bl, d = n_scaled.shape
        b = c_full.shape[0]
        row0 = mesh.rank * bl
        if _shard_in_kernel_envelope(bl, b, d):
            dn_s, dc_part = fused_ce_bwd(n_scaled, c_full, row_lse, col_lse, eps, row0)
        else:
            dn_s, dc_part = _bwd_materialized(n_scaled, c_full, row_lse, col_lse, eps, row0)
        dc = mesh.reduce_scatter_rows(dc_part)
        return (g * dn_s / tau).to(n.dtype), (g * dc).to(ctx.c_dtype), None, None, None, None


def sharded_fused_ce(n, c, mesh, temperature: float = 1.0, label_smoothing: float = 0.0,
                     max_abs_logit: float | None = None) -> torch.Tensor:
    """The global batch's bidirectional CE from this rank's blocks n, c
    [B/n, D] (the reference's ``make_sharded_fused_ce``): the same loss on
    every rank; gradients reach the rank's blocks."""
    return _ShardedFusedCE.apply(n, c, mesh, float(temperature), float(label_smoothing), max_abs_logit)


def make_sharded_fused_ce(mesh, *, temperature: float = 1.0, label_smoothing: float = 0.0,
                          max_abs_logit: float | None = None):
    """``loss(n_local, c_local)`` over ``mesh`` (see :func:`sharded_fused_ce`)."""

    def loss(n, c):
        return sharded_fused_ce(n, c, mesh, temperature, label_smoothing, max_abs_logit)

    return loss


def sharded_ce_loss(n, c, mesh, temperature: float = 1.0, label_smoothing: float = 0.0,
                    max_abs_logit: float | None = None) -> torch.Tensor:
    """:func:`sharded_fused_ce`'s value without its backward (evaluation)."""
    with torch.no_grad():
        return _sharded_ce_primal(n, mesh.all_gather_rows(c.float()), mesh, float(temperature),
                                  float(label_smoothing), max_abs_logit)[0]


def sharded_in_batch_metrics(
    n: torch.Tensor, c: torch.Tensor, mesh, *, temperature: float = 1.0, recall_ks: tuple[int, ...] = (5, 10)
) -> dict[str, torch.Tensor]:
    """:func:`fused_in_batch_metrics` of the global batch from this rank's
    blocks: the statistics of its rows against the gathered company side
    (K8 and K5/K9 at the rank's row offset), each metric's sum over the
    rank's rows all-reduced once. The same values on every rank."""
    n_scaled = n.float() / temperature
    c_full = mesh.all_gather_rows(c.float())
    bl, b = n_scaled.shape[0], c_full.shape[0]
    row_stats, _ = fused_stats_rows(n_scaled, c_full, mesh.rank * bl)
    ranks, diag = row_stats[:, 3], row_stats[:, 2]
    neg_mean = (row_stats[:, 1] - diag) / max(b - 1, 1)
    names = ["accuracy", "mrr", "auc", "positive_similarity", "negative_similarity"] + [f"recall@{k}" for k in recall_ks]
    per_row = [(ranks == 0).float(), 1.0 / (ranks + 1.0), 1.0 - ranks / max(b - 1, 1), diag, neg_mean]
    per_row += [(ranks < k).float() for k in recall_ks]
    means = dict(zip(names, mesh.all_reduce_(torch.stack([v.sum() for v in per_row])) / b))
    metrics = {k: means[k] for k in names[:5]}
    metrics["similarity_gap"] = metrics["positive_similarity"] - metrics["negative_similarity"]
    metrics["z_gap"] = metrics["similarity_gap"] / (metrics["negative_similarity"].abs() + 1e-8)
    for k in recall_ks:
        metrics[f"recall@{k}"] = means[f"recall@{k}"]
    return metrics
