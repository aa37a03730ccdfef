"""The index scan's running top-k (``ops/chunk_topk``): its plain version,
which the CPU runs and the card's kernel is held bit-equal to in
``chip_smoke.py``, against ``torch.topk`` (the scores) and the JAX
reference's ``jax.lax.top_k`` over the whole masked score row (scores and
rows, ties to the lower row), through ``serving/index._scanned_topk``
over many chunks and over one, and the indexes built on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.ops import chunk_topk as ct
from jodalrob_twotower_torch.serving import index as t_index
from jodalrob_twotower_torch.utils.profiling import kernel_launches

NEG = float(np.finfo(np.float32).min)


def _scores(kind: str, q: int, n: int, seed: int) -> np.ndarray:
    """[q, n] float32 scores: ``random`` normal; ``ascending`` each row's
    score its row number (every chunk beats the running threshold);
    ``tied`` whole rows of one value; ``few`` integers in [-2, 2] (ties
    at every place)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(q, n)).astype(np.float32)
    if kind == "ascending":
        return np.broadcast_to(np.arange(n, dtype=np.float32), (q, n)).copy()
    if kind == "tied":
        return np.full((q, n), 0.25, np.float32)
    return rng.integers(-2, 3, size=(q, n)).astype(np.float32)


def _scan(scores: np.ndarray, chunk: int | None, n_valid: int, k: int):
    """``_scanned_topk`` over ``scores`` cut into chunks of ``chunk`` columns
    (None: one chunk of all of them, an index's form without
    ``corpus_chunk``), the last padded with zero scores past n_valid."""
    q, n = scores.shape
    rows = chunk or n
    n_chunks = -(-n // rows)
    padded = np.zeros((q, n_chunks * rows), np.float32)
    padded[:, :n] = scores
    blocks = torch.from_numpy(padded).reshape(q, n_chunks, rows)
    s, i = t_index._scanned_topk(lambda qs, ci: blocks[:, ci], n_chunks, rows, n_valid, torch.zeros(q, 4), k)
    return s.numpy(), i.numpy()


def _reference(scores: np.ndarray, n_valid: int, k: int):
    """``jax.lax.top_k`` of each row with the columns past n_valid masked:
    ties go to the lower column."""
    masked = np.where(np.arange(scores.shape[1])[None, :] < n_valid, scores, NEG)
    s, i = jax.lax.top_k(jnp.asarray(masked), k)
    return np.asarray(s), np.asarray(i)


CASES = [  # (kind, queries, columns, chunk, valid, k)
    ("random", 5, 3000, 384, 3000, 7),
    ("random", 3, 5000, 1024, 4321, 100),
    ("random", 2, 9000, 2048, 8800, 400),
    ("ascending", 4, 3000, 512, 3000, 100),
    ("ascending", 2, 5000, 1000, 4999, 400),
    ("tied", 3, 2000, 384, 2000, 7),
    ("tied", 2, 3000, 700, 2900, 400),
    ("few", 4, 4000, 333, 3999, 100),
    ("random", 3, 700, 100, 700, 100),  # k equal to a chunk's width: every column passes
    ("random", 3, 1500, None, 1500, 100),  # one chunk of every row (indexes without corpus_chunk)
    ("few", 3, 1500, None, 1400, 400),  # a ShardedIndex rank's form: padding rows past the valid count
    ("random", 2, 9000, 4096, 9000, 1024),  # the kernel's largest k
]


@pytest.mark.parametrize("kind,q,n,chunk,valid,k", CASES, ids=lambda x: str(x))
def test_scan_matches_lax_top_k(kind, q, n, chunk, valid, k):
    scores = _scores(kind, q, n, seed=q * n + k)
    s, i = _scan(scores, chunk, valid, k)
    want_s, want_i = _reference(scores, valid, k)
    assert s.dtype == np.float32 and i.dtype == np.int64 and s.shape == i.shape == (q, k)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(s.view(np.int32), want_s.view(np.int32))
    masked = torch.from_numpy(np.where(np.arange(n)[None, :] < valid, scores, NEG))
    np.testing.assert_array_equal(s, torch.topk(masked, k, dim=1).values.numpy())


@pytest.mark.parametrize("chunk", [64, 1000, None], ids=["chunks", "one-chunk", "unchunked"])
def test_fewer_valid_rows_than_k_keep_the_padding_entry(chunk):
    scores = _scores("random", 3, 1000, seed=3)
    s, i = _scan(scores, chunk, 40, 100)
    want_s, want_i = _reference(scores, 40, 100)
    np.testing.assert_array_equal(i[:, :40], want_i[:, :40])
    np.testing.assert_array_equal(s[:, :40], want_s[:, :40])
    assert (s[:, 40:] == NEG).all() and (i[:, 40:] == 0).all()
    # the rescore's mask keeps the padding slots last, whatever row 0 rescores to
    corpus = torch.randn(1000, 4)
    s2, i2 = t_index._rescore_topk(torch.randn(3, 4), torch.from_numpy(s), torch.from_numpy(i), 60, corpus)
    assert (s2[:, 40:] == NEG).all() and set(i2[:, :40].flatten().tolist()) <= set(range(40))


def test_index_with_fewer_rows_than_the_rescore_depth():
    rng = np.random.default_rng(9)
    corpus = rng.normal(size=(30, 8)).astype(np.float32)
    queries = rng.normal(size=(4, 8)).astype(np.float32)
    for idx in (t_index.BruteForceIndex(corpus, corpus_chunk=16, rescore_depth=100, device="cpu"),
                t_index.Int8Index(corpus, corpus_chunk=16, rescore_depth=100, rescore_dtype="bfloat16", device="cpu")):
        res = idx.search(queries, k=10)
        assert res.indices.max() < 30 and np.isfinite(res.scores).all()
        assert (np.diff(res.scores, axis=1) <= 0).all()


def test_zero_signs_tie_and_go_to_the_lower_row():
    s = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    got_s, got_i = ct.chunk_topk_plain(torch.full((1, 4), NEG), torch.zeros((1, 4), dtype=torch.int64), s, 10, 15)
    assert got_i.tolist() == [[12, 10, 11, 13]]
    assert got_s.view(torch.int32).tolist() == s[:, [2, 0, 1, 3]].view(torch.int32).tolist()


def test_running_entries_win_ties_with_later_rows():
    best_s = torch.tensor([[3.0, 2.0, 1.0]])
    best_i = torch.tensor([[4, 2, 9]])
    block = torch.tensor([[1.0, 2.0, 5.0, 1.0]])
    s, i = ct.chunk_topk_plain(best_s, best_i, block, 20, 24)
    assert s.tolist() == [[5.0, 3.0, 2.0]] and i.tolist() == [[22, 4, 2]]


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    scores = torch.from_numpy(_scores("few", 4, 500, seed=1))
    best = torch.full((4, 50), NEG), torch.zeros((4, 50), dtype=torch.int64)
    before = kernel_launches()["chunk_topk"]
    got = ct.chunk_topk(*best, scores, 100, 550)
    want = ct.chunk_topk_plain(*best, scores, 100, 550)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernel_launches()["chunk_topk"] == before and ct.workspace(4, 50, 500, scores.device) is None


@pytest.mark.parametrize("bad", ["k", "dtype", "rows", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    best_s, best_i = torch.full((2, 8), NEG), torch.zeros((2, 8), dtype=torch.int64)
    scores = torch.zeros(2, 16)
    if bad == "k":
        best_s, best_i = torch.full((2, ct.MAX_K + 1), NEG), torch.zeros((2, ct.MAX_K + 1), dtype=torch.int64)
    elif bad == "dtype":
        scores = scores.double()
    elif bad == "shape":
        scores = torch.zeros(3, 16)
    with pytest.raises(ValueError):
        ct.chunk_topk(best_s, best_i, scores, 2**31 - 4 if bad == "rows" else 0, 16)


def test_k_past_the_cap_takes_torch_topk():
    scores = _scores("random", 2, 3000, seed=4)
    k = ct.MAX_K + 76
    s, i = _scan(scores, 1500, 2900, k)
    want_s, want_i = _reference(scores, 2900, k)
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(i, want_i)


def test_microbench_kernel_variants_are_one_scan_step():
    from jodalrob_twotower_torch import topk_microbench as topk

    q, corpus, _ = topk.inputs(q=8, c=300, d=16, device="cpu")
    starts = topk.kernel_starts(q, corpus, 20)
    assert (starts["first chunk"][0] == NEG).all() and (starts["later chunk"][0] > NEG).all()
    later = starts["later chunk"]
    s, i = topk.mm_chunk_topk(q, corpus, later, tuple(t.clone() for t in later), 300)
    want_s, want_i = ct.chunk_topk_plain(*later, q @ corpus.T, 300, 600)
    assert torch.equal(s, want_s) and torch.equal(i, want_i) and (i < 600).all()
    assert topk.kernel_launches_per_run(5) == 2 * 2 * (1 + 2 * 6)
