"""Expert dispatch of a mixture-of-experts layer: the (token, expert) pairs
that the router chose, sorted by expert, two grouped bf16 products over each
expert's rows and a weighted combine.

A layer of T tokens routed to k experts each has P = T k pairs; pair p is
token p // k's choice p % k. A pair routed to expert id E (one past the last)
is dropped: its token is padding. The four steps, each a kernel on the card
and a plain version that CPU tensors take:

* :func:`sort_pairs`: a stable counting sort of the pairs by expert id, done
  on the card with no host sync: each expert's count, its first row in the
  sorted order (``offsets``), ``perm`` (sorted row -> pair) and ``inv``
  (pair -> sorted row). With ``tally`` ([E, 2] int64) the sort adds each
  expert's pairs to ``tally[:, 0]`` and one to ``tally[:, 1]`` where it got
  any: the expert-load counter, read after a window (:func:`expert_tally`).
* :func:`grouped_gate_up`: for each sorted row, h = silu(x W_g^T) * (x W_u^T)
  with x its token's row (gathered in the product's loads) and W_g, W_u its
  expert's halves of ``w_gate_up`` [E, 2I, H]; h [P, I] bf16 in sorted order.
* :func:`grouped_down`: y = w (h W_d^T), W_d the expert's [H, I] and w the
  pair's routing weight; y [P, H] bf16 in sorted order.
* :func:`combine`: each token's new residual, ``resid + shared + sum_j
  y[inv[t k + j]]`` summed in float32 in choice order, in the residual's
  dtype; a dropped pair adds nothing.

The sort and the grouped products are CUDA (``csrc/moe_dispatch.cu``, built
by ``ops/_build``; its header says how each is laid out); the combine, a
weighted elementwise sum, is Triton, compiled at its first launch. The
grouped products take their tiles from the counts on the card, so a launch
has enough row tiles for any routing, ceil(P / 128) + E, and those past the
last expert's tiles return at once. Rows of dropped pairs in h and y are
left unwritten: the combine never reads them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from jodalrob_twotower_torch.ops import _build

# the Triton module and its language, bound by _combine_jit() at the
# first launch (this module is imported where triton is not installed)
triton = None
tl = None

MAX_EXPERTS = 256  # csrc/moe_dispatch.cu kMaxBuckets - 1
COMBINE_BLOCK = 1024  # columns a combine program sums

_tallies: dict[tuple, torch.Tensor] = {}


# ---------------------------------------------------------------- plain versions

def sort_pairs_plain(expert_ids: torch.Tensor, n_experts: int, tally: torch.Tensor | None = None):
    """(perm, inv, counts, offsets): ``expert_ids`` int32 [P] in [0, E]
    (E drops the pair) sorted stably; counts [E + 1] and offsets [E + 1]
    int32 (the first sorted row of each expert, the drop bucket last)."""
    ids = expert_ids.long()
    perm = torch.sort(ids, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    counts = torch.bincount(ids, minlength=n_experts + 1)[: n_experts + 1]
    offsets = torch.cumsum(counts, 0) - counts
    if tally is not None:
        tally[:, 0] += counts[:n_experts]
        tally[:, 1] += (counts[:n_experts] > 0).long()
    return perm.int(), inv.int(), counts.int(), offsets.int()


def _expert_rows(counts: torch.Tensor, offsets: torch.Tensor, n_experts: int):
    for e, (c, o) in enumerate(zip(counts[:n_experts].tolist(), offsets[:n_experts].tolist())):
        if c:
            yield e, slice(o, o + c)


def grouped_gate_up_plain(x, w_gate_up, perm, counts, offsets, top_k: int) -> torch.Tensor:
    n_exp, two_i, _ = w_gate_up.shape
    inter = two_i // 2
    h = torch.zeros((perm.numel(), inter), dtype=x.dtype, device=x.device)
    for e, rows in _expert_rows(counts, offsets, n_exp):
        xs = x.index_select(0, perm[rows].long() // top_k)
        g, u = F.linear(xs, w_gate_up[e, :inter]), F.linear(xs, w_gate_up[e, inter:])
        h[rows] = (F.silu(g.float()) * u.float()).to(x.dtype)
    return h


def grouped_down_plain(h, w_down, perm, counts, offsets, weights) -> torch.Tensor:
    n_exp, hidden, _ = w_down.shape
    y = torch.zeros((perm.numel(), hidden), dtype=h.dtype, device=h.device)
    w = weights.reshape(-1).float()
    for e, rows in _expert_rows(counts, offsets, n_exp):
        y[rows] = (F.linear(h[rows], w_down[e]).float() * w[perm[rows].long(), None]).to(h.dtype)
    return y


def combine_plain(y, inv, expert_ids, shared, resid, n_experts: int) -> torch.Tensor:
    t, h = resid.shape
    k = inv.numel() // t
    keep = (expert_ids.reshape(t, k) < n_experts)
    rows = y.index_select(0, inv.long()).reshape(t, k, h).float() * keep[..., None]
    out = resid.float() + shared.float()
    for j in range(k):  # in choice order, as the kernel sums
        out = out + rows[:, j]
    return out.to(resid.dtype)


# ---------------------------------------------------------------- the kernels

def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_dispatch")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_sort_pairs.argtypes = [ptr, i32, i32] + [ptr] * 7
        lib.moe_sort_workspace.argtypes = [i32]
        lib.moe_sort_workspace.restype = i32
        lib.moe_grouped_gate_up.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.moe_grouped_down.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        for fn in (lib.moe_sort_pairs, lib.moe_grouped_gate_up, lib.moe_grouped_down):
            fn.restype = ctypes.c_int
        lib.moe_dispatch_error_string.argtypes = [i32]
        lib.moe_dispatch_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {_lib().moe_dispatch_error_string(err).decode()}")


def _combine_kernel(y_ptr, inv_ptr, ids_ptr, shared_ptr, resid_ptr, out_ptr, hidden, n_experts,
                    TOP_K: tl.constexpr, BLOCK: tl.constexpr):
    t = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    cmask = cols < hidden
    acc = tl.load(resid_ptr + t * hidden + cols, mask=cmask, other=0.0).to(tl.float32)
    acc += tl.load(shared_ptr + t * hidden + cols, mask=cmask, other=0.0).to(tl.float32)
    for j in tl.static_range(TOP_K):
        keep = tl.load(ids_ptr + t * TOP_K + j) < n_experts
        row = tl.load(inv_ptr + t * TOP_K + j).to(tl.int64)
        acc += tl.load(y_ptr + row * hidden + cols, mask=cmask & keep, other=0.0).to(tl.float32)
    tl.store(out_ptr + t * hidden + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)


_jitted: dict = {}


def _combine_jit():
    """The combine kernel, compiled by Triton at its first launch."""
    global triton, tl
    if not _jitted:
        import triton as triton_mod
        import triton.language as tl_mod

        triton, tl = triton_mod, tl_mod
        _jitted["combine"] = triton.jit(_combine_kernel)
    return _jitted["combine"]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- the wrappers

def sort_pairs(expert_ids: torch.Tensor, n_experts: int, tally: torch.Tensor | None = None):
    """See :func:`sort_pairs_plain`. CPU tensors take the plain version; CUDA
    tensors launch the sort (two launches) or raise."""
    if expert_ids.dtype != torch.int32 or expert_ids.dim() != 1:
        raise ValueError(f"expert_ids must be int32 [P], got {expert_ids.dtype} {tuple(expert_ids.shape)}")
    if tally is not None and (tally.shape != (n_experts, 2) or tally.dtype != torch.int64 or not tally.is_contiguous()):
        raise ValueError(f"tally must be a contiguous int64 [{n_experts}, 2], got {tally.dtype} {tuple(tally.shape)}")
    if expert_ids.device.type == "cpu":
        return sort_pairs_plain(expert_ids, n_experts, tally)
    if not 1 <= n_experts <= MAX_EXPERTS or not expert_ids.is_contiguous():
        raise ValueError(f"the sort kernel takes 1 to {MAX_EXPERTS} experts and contiguous ids, got {n_experts}")
    p = expert_ids.numel()
    dev = expert_ids.device
    perm, inv = torch.empty(p, dtype=torch.int32, device=dev), torch.empty(p, dtype=torch.int32, device=dev)
    counts = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    lib = _lib()
    workspace = torch.empty(lib.moe_sort_workspace(p), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.moe_sort_pairs(expert_ids.data_ptr(), p, n_experts, perm.data_ptr(), inv.data_ptr(),
                                 counts.data_ptr(), offsets.data_ptr(), tally.data_ptr() if tally is not None else None,
                                 workspace.data_ptr(), _stream(expert_ids))
    _raise_on(err, "moe_sort_pairs")
    sort_pairs.launches += 2
    return perm, inv, counts, offsets


def _check_product(a, w, perm, counts, what: str) -> None:
    if a.dtype != w.dtype or a.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{what}: activations [N, K] and weights [E, ., K] of one dtype, got "
                         f"{a.dtype} {tuple(a.shape)}, {w.dtype} {tuple(w.shape)}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: activations and weights must be contiguous")
    if counts.numel() != w.shape[0] + 1 or perm.dtype != torch.int32:
        raise ValueError(f"{what}: counts [E + 1] and int32 perm, got {counts.numel()} for E={w.shape[0]}, {perm.dtype}")
    if a.device.type != "cpu" and (a.dtype != torch.bfloat16 or a.shape[1] % 64):
        raise ValueError(f"{what}: the kernel takes bfloat16 operands of a depth that is a multiple of 64, "
                         f"got {a.dtype} depth {a.shape[1]}")


def grouped_gate_up(x, w_gate_up, perm, counts, offsets, top_k: int) -> torch.Tensor:
    """h [P, I] in sorted order (module docstring): x [T, H], w_gate_up
    [E, 2I, H] in one dtype. CPU tensors take the plain version; CUDA
    tensors (bfloat16, H a multiple of 64, I of 128) launch the kernel or
    raise."""
    _check_product(x, w_gate_up, perm, counts, "grouped_gate_up")
    if x.device.type == "cpu":
        return grouped_gate_up_plain(x, w_gate_up, perm, counts, offsets, top_k)
    n_exp, two_i, hidden = w_gate_up.shape
    inter = two_i // 2
    if inter % 128:
        raise ValueError(f"grouped_gate_up: the kernel takes a width that is a multiple of 128, got {inter}")
    h = torch.empty((perm.numel(), inter), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().moe_grouped_gate_up(x.data_ptr(), w_gate_up.data_ptr(), h.data_ptr(), perm.data_ptr(),
                                         counts.data_ptr(), offsets.data_ptr(), n_exp, perm.numel(), hidden, inter,
                                         top_k, _stream(x))
    _raise_on(err, "moe_grouped_gate_up")
    grouped_gate_up.launches += 1
    return h


def grouped_down(h, w_down, perm, counts, offsets, weights) -> torch.Tensor:
    """y [P, H] in sorted order (module docstring): h [P, I], w_down
    [E, H, I], weights float32 [P] (pair order). CPU tensors take the plain
    version; CUDA tensors (bfloat16, I a multiple of 64, H of 256) launch
    the kernel or raise."""
    _check_product(h, w_down, perm, counts, "grouped_down")
    if weights.dtype != torch.float32 or weights.numel() != perm.numel():
        raise ValueError(f"weights must be float32 [P], got {weights.dtype} {tuple(weights.shape)}")
    if h.device.type == "cpu":
        return grouped_down_plain(h, w_down, perm, counts, offsets, weights)
    n_exp, hidden, inter = w_down.shape
    if hidden % 256:
        raise ValueError(f"grouped_down: the kernel takes a hidden size that is a multiple of 256, got {hidden}")
    weights = weights.contiguous()
    y = torch.empty((perm.numel(), hidden), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        err = _lib().moe_grouped_down(h.data_ptr(), w_down.data_ptr(), y.data_ptr(), perm.data_ptr(),
                                      weights.data_ptr(), counts.data_ptr(), offsets.data_ptr(), n_exp, perm.numel(),
                                      hidden, inter, _stream(h))
    _raise_on(err, "moe_grouped_down")
    grouped_down.launches += 1
    return y


def combine(y, inv, expert_ids, shared, resid, n_experts: int) -> torch.Tensor:
    """resid + shared + each token's routed rows (module docstring), in
    resid's dtype: y [P, H] sorted, inv and expert_ids int32 [P], shared
    and resid [T, H]. CPU tensors take the plain version."""
    if not (y.is_contiguous() and shared.is_contiguous() and resid.is_contiguous()):
        raise ValueError("combine's inputs must be contiguous")
    if resid.device.type == "cpu":
        return combine_plain(y, inv, expert_ids, shared, resid, n_experts)
    t, hidden = resid.shape
    out = torch.empty_like(resid)
    with torch.cuda.device(resid.device):
        _combine_jit()[(t, -(-hidden // COMBINE_BLOCK))](y, inv, expert_ids, shared, resid, out, hidden, n_experts,
                                                         TOP_K=inv.numel() // t, BLOCK=COMBINE_BLOCK, num_warps=4)
    combine.launches += 1
    return out


sort_pairs.launches = grouped_gate_up.launches = grouped_down.launches = combine.launches = 0


def tally_buffer(device, n_layers: int, n_experts: int) -> torch.Tensor:
    """The expert-load counter of ``device`` for a stack of ``n_layers`` MoE
    layers: int64 [n_layers, E, 2] (tokens, batches with any), made zero at
    first use and summed on the card by every dispatch."""
    device = torch.device(device)
    key = (device.type, device.index, n_layers, n_experts)
    t = _tallies.get(key)
    if t is None:
        # a normal tensor even when first asked for under inference mode, so
        # that a dispatch outside it can still add to it
        with torch.inference_mode(False):
            t = _tallies[key] = torch.zeros((n_layers, n_experts, 2), dtype=torch.int64, device=device)
    return t


def expert_tally(n_layers: int, n_experts: int) -> np.ndarray:
    """The counters of stacks of ``n_layers`` layers of ``n_experts``,
    summed over the devices they were kept on: int64 [L, E, 2] (zeros
    before any such layer ran). Synchronises."""
    out = np.zeros((n_layers, n_experts, 2), dtype=np.int64)
    for (_, _, layers, experts), t in _tallies.items():
        if (layers, experts) == (n_layers, n_experts):
            out += t.cpu().numpy()
    return out


def reset_expert_tally() -> None:
    for t in _tallies.values():
        t.zero_()


def launches() -> dict[str, int]:
    return {f.__name__: f.launches for f in (sort_pairs, grouped_gate_up, grouped_down, combine)}
