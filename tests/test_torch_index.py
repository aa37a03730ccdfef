"""The port's MIPS indexes against the JAX package's on the same corpus and
queries: int8 quantization bit for bit, exact and int8 top-k (flat and
chunked, with and without rescore, with and without an ``approx_recall``
target) index for index with scores within float32 summation-order error,
the recall targets both refuse, and the npz format both ways; and a one-rank
``ShardedIndex`` against the port's own single-device index of its kind."""

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.parallel.mesh import Mesh
from jodalrob_twotower_torch.serving import index as t_index
from jodalrob_twotower_tpu.serving import index as j_index

RTOL, ATOL = 1e-5, 1e-6  # float32 sums taken in another order


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return _unit(rng, 1000, 16), _unit(rng, 24, 16)  # 1000 = 3*384 + 232: padded chunks


def test_quantize_int8_bit_equal(data):
    corpus, _ = data
    corpus = np.concatenate([corpus, np.zeros((2, 16), np.float32)])  # zero rows: scale 0
    jv, js = j_index.quantize_int8(corpus)
    for v, s in (t_index.quantize_int8(corpus), t_index.quantize_int8(torch.from_numpy(corpus))):
        np.testing.assert_array_equal(np.asarray(v), jv)
        np.testing.assert_array_equal(np.asarray(s), js)
    # the reference's own jitted path multiplies by XLA's reciprocal of 127:
    # its scales sit within one ulp of its host path's, its values are equal
    jv_dev, js_dev = j_index.quantize_int8(j_index.jnp.asarray(corpus))
    np.testing.assert_array_equal(np.asarray(jv_dev), jv)
    np.testing.assert_array_max_ulp(np.asarray(js_dev), js, maxulp=1)


CONFIGS = [
    ("exact", {}),
    ("exact", {"corpus_chunk": 384}),
    ("exact", {"corpus_chunk": 384, "rescore_depth": 20}),
    ("int8", {}),
    ("int8", {"corpus_chunk": 384}),
    ("int8", {"rescore_depth": 20}),
    ("int8", {"corpus_chunk": 384, "rescore_depth": 20}),
    ("int8", {"corpus_chunk": 384, "rescore_depth": 20, "rescore_dtype": "bfloat16"}),
    ("int8", {"rescore_depth": 3, "rescore_dtype": "bfloat16"}),
]


def _build(pkg, kind, corpus, kw):
    cls = {"exact": pkg.BruteForceIndex, "int8": pkg.Int8Index}[kind]
    if pkg is t_index:
        kw = {**kw, "device": "cpu"}
    return cls(corpus, query_chunk=16, **kw)


@pytest.mark.parametrize("kind,kw", CONFIGS, ids=lambda x: str(x))
def test_topk_matches_reference(data, kind, kw):
    corpus, queries = data
    want = _build(j_index, kind, corpus, kw).search(queries, k=7)
    got = _build(t_index, kind, corpus, kw).search(queries, k=7)
    assert got.indices.dtype == np.int32 and got.scores.dtype == np.float32
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL)
    assert got.indices.max() < len(corpus)  # never a padding row
    assert t_index.recall_vs_exact(got, want) == j_index.recall_vs_exact(want, want) == 1.0


def test_exact_index_is_a_float32_scan(data):
    corpus, queries = data
    res = _build(t_index, "exact", corpus, {}).search(queries, k=5)
    sims = queries @ corpus.T
    expected = np.argsort(-sims, axis=1)[:, :5]
    np.testing.assert_array_equal(res.indices, expected)
    np.testing.assert_allclose(res.scores, np.take_along_axis(sims, expected, axis=1), rtol=1e-5)


@pytest.mark.parametrize("kind,kw", [CONFIGS[1], CONFIGS[7]], ids=["exact-chunked", "int8-bf16-rescore"])
def test_reference_saved_index_loads(tmp_path, data, kind, kw):
    corpus, queries = data
    j_idx = _build(j_index, kind, corpus, kw)
    path = tmp_path / "ref.npz"
    j_index.save_index(j_idx, path)
    loaded = t_index.load_index(path, device="cpu")
    assert type(loaded).__name__ == type(j_idx).__name__ and len(loaded) == len(corpus)
    assert loaded.corpus_chunk == j_idx.corpus_chunk and loaded.rescore_depth == j_idx.rescore_depth
    want, got = j_idx.search(queries, k=5), loaded.search(queries, k=5)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL)
    # and back: the port's file loads in the reference
    t_index.save_index(loaded, tmp_path / "port.npz")
    again = j_index.load_index(tmp_path / "port.npz").search(queries, k=5)
    np.testing.assert_array_equal(again.indices, want.indices)


@pytest.mark.parametrize("approx", [0.9, 0.95])
@pytest.mark.parametrize("kind,kw", CONFIGS, ids=lambda x: str(x))
def test_approx_recall_matches_reference(data, kind, kw, approx):
    """The reference's approx_max_k off the TPU is XLA's exact fallback: the
    port's exact selection gives its indices, scores within float32
    summation-order error, and keeps the recall target."""
    corpus, queries = data
    kw = {**kw, "approx_recall": approx}
    want = _build(j_index, kind, corpus, kw).search(queries, k=7)
    got_index = _build(t_index, kind, corpus, kw)
    got = got_index.search(queries, k=7)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL)
    plain = _build(t_index, kind, corpus, {k: v for k, v in kw.items() if k != "approx_recall"}).search(queries, k=7)
    np.testing.assert_array_equal(got.indices, plain.indices)
    assert got_index.approx_recall == approx


@pytest.mark.parametrize("approx", [0.0, -0.1, 1.5])
def test_out_of_range_approx_recall_refused_by_both(data, approx):
    corpus, queries = data
    for kind in ("exact", "int8"):
        with pytest.raises(Exception, match="recall_target out of range"):  # jax.lax.approx_max_k, at search
            _build(j_index, kind, corpus, {"approx_recall": approx}).search(queries, k=7)
        with pytest.raises(ValueError, match=r"approx_recall must be in \(0, 1\]"):  # the port, at build
            _build(t_index, kind, corpus, {"approx_recall": approx})


def test_saved_approx_recall_round_trips(tmp_path, data):
    corpus, queries = data
    t_index.save_index(_build(t_index, "int8", corpus, {"approx_recall": 0.9, "rescore_depth": 20}), tmp_path / "a.npz")
    j_loaded = j_index.load_index(tmp_path / "a.npz")
    t_loaded = t_index.load_index(tmp_path / "a.npz", device="cpu")
    assert j_loaded.approx_recall == t_loaded.approx_recall == 0.9
    np.testing.assert_array_equal(t_loaded.search(queries, k=7).indices, j_loaded.search(queries, k=7).indices)


def test_int8_index_checks_and_size(data):
    corpus, _ = data
    with pytest.raises(ValueError, match="rescore_depth must be >= 1"):
        t_index.BruteForceIndex(corpus, rescore_depth=0, device="cpu")
    with pytest.raises(ValueError, match="rescore_dtype"):
        t_index.Int8Index(corpus, rescore_depth=5, rescore_dtype="fp8", device="cpu")
    values, scales = t_index.quantize_int8(corpus)
    with pytest.raises(ValueError, match="full-precision corpus"):
        t_index.Int8Index.from_quantized(values, scales, rescore_depth=5, rescore_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="same corpus"):
        t_index.Int8Index.from_quantized(
            values, scales, rescore_depth=5, rescore_dtype="bfloat16", rescore_rows=corpus[:-1], device="cpu"
        )
    assert t_index.Int8Index(corpus, device="cpu").nbytes < corpus.nbytes / 3


def test_int8_zero_rows_safe():
    corpus = np.zeros((64, 16), np.float32)
    corpus[0, 0] = 1.0
    res = t_index.Int8Index(corpus, device="cpu").search(np.ones((2, 16), np.float32), k=3)
    assert np.isfinite(res.scores).all() and res.indices[0, 0] == 0


SHARDED = [  # (kind, keyword arguments): each rescore below the corpus's 1000 rows and above them
    ("exact", {}),
    *(("exact", {"rescore_depth": d}) for d in (20, 5000)),
    ("int8", {}),
    *(("int8", {"rescore_depth": d, "rescore_dtype": "int8"}) for d in (20, 5000)),
    *(("int8", {"rescore_depth": d, "rescore_dtype": "bfloat16"}) for d in (20, 5000)),
]


@pytest.mark.parametrize("kind,kw", SHARDED, ids=lambda x: str(x))
def test_one_rank_sharded_index_equals_the_single_device_index(data, kind, kw):
    """A one-rank mesh's block is the whole corpus, unpadded: its search,
    merge included, gives the single-device index's answers bit for bit."""
    corpus, queries = data
    mesh = Mesh("cpu")
    assert mesh.size == 1
    got = t_index.ShardedIndex(corpus, mesh, kind=kind, query_chunk=16, **kw).search(queries, k=7)
    want = _build(t_index, kind, corpus, kw).search(queries, k=7)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores.view(np.int32), want.scores.view(np.int32))
