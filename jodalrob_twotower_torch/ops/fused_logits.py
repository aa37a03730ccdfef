"""Fused in-batch-negative CE loss (port of the lean loss path of
``jodalrob_twotower_tpu/ops/fused_logits.py``).

The bidirectional CE over S = (N/tau) C^T needs, per row i and column j, only
``row_lse_i``, ``col_lse_j`` and the diagonal S_ii:

  L = 1/2 mean_i(row_lse_i - S_ii) + 1/2 mean_j(col_lse_j - S_jj)

and its gradient contracts dL/dS = (1/2B)[P_row + P_col - 2 delta] against C
and N. Two hand-written CUDA kernels compute both without writing S:

* :func:`fused_lean_lse` -> ``csrc/fused_ce_fwd.cu``, replacing the TPU
  kernels ``fused_logits.py:241 _fwd_lean_kernel`` and ``:280
  _fwd_lean_nomax_kernel`` (through ``_fused_lean_call``);
* :func:`fused_ce_bwd` -> ``csrc/fused_ce_bwd.cu``, replacing ``:819
  _bwd_kernel`` (through ``_fused_bwd_call``).

Both take N/tau and C in bf16 with f32 accumulation, as the TPU kernels do.
Each has a plain PyTorch version beside it (``*_plain``), taken only for CPU
tensors; a CUDA tensor launches the kernel or raises.
:func:`fused_bidirectional_ce` wraps them in one ``torch.autograd.Function``.

Dispatch (:func:`ce_route`) follows the reference's envelopes: B % 128 == 0,
B <= 8192, D % 128 == 0 and no label smoothing take the kernels. The blocked
kernels for 8192 < B <= 65536 and the stats kernel that label smoothing
needs are not ported yet: on CUDA those cases raise ``NotImplementedError``
naming the missing kernel, on the CPU they take the plain versions. Shapes
outside both envelopes take the materialized float32 path, as
``_ce_primal``/``_ce_bwd`` do in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from jodalrob_twotower_torch.ops import _build

_BM = 128  # the reference's row-block height: B must be a multiple
_MAX_B = 8192  # the reference's single-kernel envelope
_MAX_B_BLOCKED = 65536  # the reference's col-blocked envelope (K7, K10)
_BN_BLOCKED = 1024
_NOMAX_MAX_ABS = 60.0  # |S| bound under which exp(S) cannot overflow f32
_KERNEL_D = 128  # the embedding width the CUDA kernels are compiled for
_KERNEL_ROWS = 64  # the CUDA kernels' row block


def _supported(b: int, d: int) -> bool:
    return b % _BM == 0 and b <= _MAX_B and d % 128 == 0


def _blocked_supported(b: int, d: int) -> bool:
    return _MAX_B < b <= _MAX_B_BLOCKED and b % _BN_BLOCKED == 0 and d % 128 == 0


def ce_route(b: int, d: int, label_smoothing: float, on_cuda: bool) -> str:
    """How the fused CE runs for a [B, D] batch: "kernel" (the lean forward
    and the backward, as CUDA kernels on the card or their plain versions on
    the CPU), "stats" (the full-statistics forward: the plain version on the
    CPU), or "materialized" (float32 [B, B] logits, outside every envelope).
    Raises ``NotImplementedError`` on CUDA where the reference would run a
    kernel this port does not have yet."""
    if _supported(b, d) or _blocked_supported(b, d):
        if on_cuda:
            if not _supported(b, d):
                raise NotImplementedError(
                    f"B={b} lies in the reference's col-blocked range (8192 < B <= 65536), "
                    "whose kernels (fused_logits.py _fwd_lean_blocked_kernel, "
                    "_bwd_dn/dc_blocked_kernel) are not ported to CUDA yet"
                )
            if label_smoothing:
                raise NotImplementedError(
                    "label_smoothing > 0 needs the fused stats kernel (fused_logits.py "
                    "_fwd_kernel), which is not ported to CUDA yet"
                )
            if d != _KERNEL_D:
                raise NotImplementedError(
                    f"the CUDA CE kernels are built for D={_KERNEL_D}, got D={d}"
                )
        return "kernel" if label_smoothing == 0 else "stats"
    return "materialized"


# -- K6: the lean forward -------------------------------------------------------


def fused_lean_lse_plain(
    n_scaled: torch.Tensor, c: torch.Tensor, *, nomax: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_lse [rows], col_lse [B]) of S = n_scaled c^T, from bf16 operands
    with f32 accumulation; ``nomax`` takes the unshifted sums of exp."""
    s = n_scaled.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
    if nomax:
        es = torch.exp(s)
        return torch.log(es.sum(1)), torch.log(es.sum(0))
    return torch.logsumexp(s, 1), torch.logsumexp(s, 0)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce_fwd")
    if not getattr(lib, "_typed", False):
        lib.fused_lean_lse.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fused_lean_lse.restype = ctypes.c_int
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
        lib.fused_ce_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_ce_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(n: torch.Tensor, c: torch.Tensor, what: str) -> None:
    if n.dim() != 2 or c.dim() != 2 or n.shape[1] != c.shape[1]:
        raise ValueError(f"{what}: n [rows, D] and c [B, D] needed, got {tuple(n.shape)}, {tuple(c.shape)}")
    if n.device != c.device:
        raise ValueError(f"{what}: n and c must share a device, got {n.device}, {c.device}")


def _check_kernel_operands(n: torch.Tensor, c: torch.Tensor, what: str) -> None:
    if n.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {n.device}")
    rows, d = n.shape
    b = c.shape[0]
    if d != _KERNEL_D or rows % _KERNEL_ROWS or b % _KERNEL_ROWS or rows == 0 or b == 0:
        raise ValueError(
            f"{what}: the kernel takes D={_KERNEL_D} and rows, B multiples of "
            f"{_KERNEL_ROWS}, got n {tuple(n.shape)}, c {tuple(c.shape)}"
        )
    for t in (n, c):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: n and c must be contiguous, 16-byte aligned bfloat16")


def fused_lean_lse(
    n_scaled: torch.Tensor, c: torch.Tensor, *, nomax: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: (row_lse [rows], col_lse [B]) of S = bf16(n_scaled) bf16(c)^T
    without writing S (see :func:`fused_lean_lse_plain`). CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    or raise. ``launches`` counts the kernel's launches."""
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
    workspace = torch.empty((2, rows // _KERNEL_ROWS, b), dtype=torch.float32, device=nb.device)
    lib = _fwd_lib()
    with torch.cuda.device(nb.device):
        err = lib.fused_lean_lse(
            nb.data_ptr(), cb.data_ptr(), row_lse.data_ptr(), col_lse.data_ptr(),
            workspace.data_ptr(), rows, b, d, int(nomax), torch.cuda.current_stream().cuda_stream,
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
    """K11: see :func:`fused_ce_bwd_plain` for the function. CPU tensors
    take the plain version; CUDA tensors launch the kernel (a dn sweep and a
    dc sweep, no atomics) on the current stream or raise. ``launches``
    counts the kernel's launches."""
    _check_operands(n_scaled, c, "fused_ce_bwd")
    rows, b = n_scaled.shape[0], c.shape[0]
    if row_lse.shape != (rows,) or col_lse.shape != (b,):
        raise ValueError(f"fused_ce_bwd: row_lse [{rows}] and col_lse [{b}] needed")
    if not 0 <= row_offset <= b - rows:
        raise ValueError(f"fused_ce_bwd: row_offset {row_offset} places rows outside [0, {b})")
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


# -- the stats forward (K5's plain version) and the materialized path -------------


def _stats_materialized(n_scaled: torch.Tensor, c: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per row lse, sum, diag; per column lse, sum of S = n_scaled c^T in f32."""
    s = n_scaled @ c.T
    return {
        "row_lse": torch.logsumexp(s, 1), "row_sum": s.sum(1), "diag": torch.diagonal(s),
        "col_lse": torch.logsumexp(s, 0), "col_sum": s.sum(0),
    }


def fused_stats_plain(n_scaled: torch.Tensor, c: torch.Tensor) -> dict[str, torch.Tensor]:
    """The statistics the reference's ``_fwd_kernel`` (K5) gives the
    label-smoothed loss, from bf16 operands with f32 accumulation. Plain
    PyTorch: K5 is not ported yet."""
    return _stats_materialized(n_scaled.to(torch.bfloat16).float(), c.to(torch.bfloat16).float())


def _loss_from_stats(stats: dict[str, torch.Tensor], label_smoothing: float) -> torch.Tensor:
    b = stats["row_lse"].shape[0]
    eps = label_smoothing

    def side(lse, ssum):
        base = (1.0 - eps) * (lse - stats["diag"])
        if eps:
            base = base + (eps / b) * (b * lse - ssum)
        return base.mean()

    return 0.5 * (side(stats["row_lse"], stats["row_sum"]) + side(stats["col_lse"], stats["col_sum"]))


def _bwd_materialized(n_scaled, c32, row_lse, col_lse, eps):
    b = n_scaled.shape[0]
    s = n_scaled @ c32.T
    eye = torch.eye(b, dtype=torch.float32, device=s.device)
    a = (0.5 / b) * (
        torch.exp(s - row_lse[:, None]) + torch.exp(s - col_lse[None, :])
        - 2.0 * (1.0 - eps) * eye - 2.0 * eps / b
    )
    return a @ c32, a.T @ n_scaled


def _ce_primal(n, c, temperature, label_smoothing, max_abs_logit):
    """Loss and the (row_lse, col_lse) residuals (reference ``_ce_primal``,
    fused_logits.py:907-931). n/tau is formed in f32 before any bf16
    rounding; the diagonal is the rowsum of the bf16-rounded operands, the
    values the kernel's S is made of."""
    n_scaled = n.float() / temperature
    b, d = n_scaled.shape
    route = ce_route(b, d, label_smoothing, n.is_cuda)
    if route == "kernel":
        nomax = max_abs_logit is not None and max_abs_logit <= _NOMAX_MAX_ABS
        row_lse, col_lse = fused_lean_lse(n_scaled, c.float(), nomax=nomax)
        nb = n_scaled.to(torch.bfloat16).float()
        cb = c.float().to(torch.bfloat16).float()
        diag = (nb * cb).sum(1)
        loss = 0.5 * ((row_lse - diag).mean() + (col_lse - diag).mean())
        return loss, row_lse, col_lse
    if route == "stats":
        stats = fused_stats_plain(n_scaled, c.float())
    else:
        stats = _stats_materialized(n_scaled, c.float())
    return _loss_from_stats(stats, label_smoothing), stats["row_lse"], stats["col_lse"]


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
        if ce_route(b, d, eps, n.is_cuda) == "materialized":
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
