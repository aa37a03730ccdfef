"""The exact running top-k of an index scan (``csrc/chunk_topk.cu``).

One step of ``serving/index._scanned_topk``: the running top k of each query
(scores [Q, k] float32, descending, and int64 rows [Q, k]) becomes the best
k of itself and a [Q, C] float32 score block whose column c is the global
row ``row0 + c``, counted only below ``n_valid``. Entries are ordered by
score, descending, and at equal scores by the lower row, as
``jax.lax.top_k`` breaks ties; slots that no valid row fills keep the
padding entry the scan starts from (the float32 minimum, row 0). Scores
must not be NaN.

* :func:`chunk_topk_plain` is the plain version, in PyTorch.
* :func:`chunk_topk` runs it for CPU tensors, and on CUDA launches the
  kernel, which updates the running top-k in place: per step of at most
  262,144 columns a slice select (a CTA per query and 8,192 columns, reading
  each score once and keeping only those above the running k-th score) and
  a merge (a CTA per query), on the current stream, with no host sync. It
  replaces no TPU kernel: the reference left selection to XLA.
  ``launches`` counts its launches, two a step.
* :func:`tally` reads the kernel's device counters (slices seen, slices
  that ran the radix select, candidates emitted); it synchronises, so it is
  read off the search path.
"""

from __future__ import annotations

import ctypes

import torch

from jodalrob_twotower_torch.ops import _build

MAX_K = 1024  # the kernel's largest k (csrc/chunk_topk.cu kMaxK)
SLICE = 8192  # columns a CTA of the slice select reads (kSlice)
WINDOW = 262_144  # columns a step reads, 32 slices (kWindow); a wider block takes several steps
NEG = float(torch.finfo(torch.float32).min)  # the padding entry's score

_tallies: dict[int, torch.Tensor] = {}  # device index -> [3] int64 on that card


def chunk_topk_plain(best_s: torch.Tensor, best_i: torch.Tensor, scores: torch.Tensor, row0: int,
                     n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The best k of (best_s, best_i) and the block's valid columns, as new
    tensors: the entries above the k-th largest score, then those equal to
    it in the order running entries, block columns (rows ascending), all
    ordered by a stable sort on the score."""
    q, k = best_s.shape
    valid = max(0, min(scores.shape[1], n_valid - row0))
    rows = torch.arange(row0, row0 + valid, dtype=torch.int64, device=scores.device)
    vals = torch.cat([best_s, scores[:, :valid].float()], dim=1)
    ids = torch.cat([best_i, rows.expand(q, valid)], dim=1)
    kth = torch.topk(vals, k, dim=1).values[:, -1:]
    eq = vals == kth
    take = (vals > kth) | (eq & (eq.cumsum(1) <= k - (vals > kth).sum(1, keepdim=True)))
    pos = take.nonzero()[:, 1].view(q, k)  # k a row, in ascending position
    s, i = vals.gather(1, pos), ids.gather(1, pos)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    return s.gather(1, order), i.gather(1, order)


def workspace(q: int, k: int, cols: int, device: torch.device) -> tuple | None:
    """The kernel's scratch for a scan of [q, cols] blocks at k: candidate
    counts [q] (zero; the merge leaves them zero) and the candidates' scores
    and rows [q, slices x k]. None on the CPU."""
    if device.type != "cuda":
        return None
    cap = -(-min(cols, WINDOW) // SLICE) * k
    return (torch.zeros(q, dtype=torch.int32, device=device),
            torch.empty((q, cap), dtype=torch.float32, device=device),
            torch.empty((q, cap), dtype=torch.int32, device=device))


def _lib() -> ctypes.CDLL:
    lib = _build.load("chunk_topk")
    if not getattr(lib, "_typed", False):
        lib.chunk_topk_step.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                                 ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                                        + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
        lib.chunk_topk_step.restype = ctypes.c_int
        lib.chunk_topk_error_string.argtypes = [ctypes.c_int]
        lib.chunk_topk_error_string.restype = ctypes.c_char_p
        for name, want in (("chunk_topk_slice", SLICE), ("chunk_topk_window", WINDOW), ("chunk_topk_max_k", MAX_K)):
            if getattr(lib, name)() != want:
                raise RuntimeError(f"csrc/chunk_topk.cu's {name} is {getattr(lib, name)()}, the wrapper's {want}")
        lib._typed = True
    return lib


def _tally(device: torch.device) -> torch.Tensor:
    t = _tallies.get(device.index)
    if t is None:
        t = _tallies[device.index] = torch.zeros(3, dtype=torch.int64, device=device)
    return t


def tally() -> dict[str, int]:
    """The kernel's counters summed over the cards it ran on: ``slices``
    seen, ``selected`` (slices with more than k scores above the threshold,
    which ran the radix select), ``candidates`` emitted. Synchronises."""
    total = [0, 0, 0]
    for t in _tallies.values():
        total = [a + b for a, b in zip(total, t.tolist())]
    return dict(zip(("slices", "selected", "candidates"), total))


def reset_tally() -> None:
    for t in _tallies.values():
        t.zero_()


def _check(best_s: torch.Tensor, best_i: torch.Tensor, scores: torch.Tensor, row0: int) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be [Q, C] float32, got {tuple(scores.shape)} {scores.dtype}")
    q, k = best_s.shape
    if best_s.dtype != torch.float32 or best_i.dtype != torch.int64 or best_i.shape != best_s.shape:
        raise ValueError(f"the running top-k must be [Q, k] float32 and int64, got {best_s.dtype} "
                         f"{tuple(best_s.shape)}, {best_i.dtype} {tuple(best_i.shape)}")
    if scores.shape[0] != q or not 1 <= k <= MAX_K:
        raise ValueError(f"{q} running rows at k={k} for a block of {scores.shape[0]} rows (k in [1, {MAX_K}])")
    if not scores.device == best_s.device == best_i.device:
        raise ValueError(f"tensors on {scores.device}, {best_s.device}, {best_i.device}")
    if row0 < 0 or row0 + scores.shape[1] >= 2**31:
        raise ValueError(f"global rows [{row0}, {row0 + scores.shape[1]}) must lie in [0, 2^31)")


def chunk_topk(best_s: torch.Tensor, best_i: torch.Tensor, scores: torch.Tensor, row0: int, n_valid: int,
               work: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the running top-k; see :func:`chunk_topk_plain` for the
    function. CPU tensors take the plain version and get new tensors. CUDA
    tensors launch the kernel, or raise, and get (best_s, best_i) updated in
    place; ``work`` is :func:`workspace` for the scan (made here if None)."""
    _check(best_s, best_i, scores, row0)
    if scores.device.type == "cpu":
        return chunk_topk_plain(best_s, best_i, scores, row0, n_valid)
    if not (best_s.is_contiguous() and best_i.is_contiguous()):
        raise ValueError("the running top-k is updated in place and must be contiguous")
    if scores.stride(1) != 1:
        scores = scores.contiguous()
    q, k = best_s.shape
    c = scores.shape[1]
    ld = scores.stride(0) if q > 1 else c
    counts, cand_s, cand_r = work if work is not None else workspace(q, k, c, scores.device)
    lib = _lib()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        tally_ptr = _tally(scores.device).data_ptr()
        for w0 in range(0, c, WINDOW):
            cols = min(WINDOW, c - w0)
            valid = max(0, min(cols, n_valid - row0 - w0))
            if not valid:  # padding alone: nothing can enter
                continue
            err = lib.chunk_topk_step(best_s.data_ptr(), best_i.data_ptr(), scores.data_ptr() + 4 * w0, ld, q, k,
                                      cols, row0 + w0, valid, counts.data_ptr(), cand_s.data_ptr(),
                                      cand_r.data_ptr(), cand_s.shape[1], tally_ptr, stream)
            if err:
                raise RuntimeError(f"chunk_topk launch failed: {lib.chunk_topk_error_string(err).decode()}")
            chunk_topk.launches += 2
    return best_s, best_i


chunk_topk.launches = 0
