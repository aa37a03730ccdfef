"""The port's serving auto-configuration against the JAX package's on the same
embeddings: the priors-only pick over a grid of targets and k, the streamed
exact scan's top-k rows, and the measured calibration with the corpus as a
tensor and as host numpy (streamed in chunks small enough to loop): the same
pick and each measured recall within 1e-6. Inputs are numpy from a seed at
D = 16; the exact reference off the TPU selects exactly in both packages, so
indices compare for equality (random unit vectors have no ties)."""

import dataclasses

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.serving import autoconfig as t_auto
from jodalrob_twotower_tpu.serving import autoconfig as j_auto

RECALL_ATOL = 1e-6  # both count the same overlaps of equal index sets


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU work runs fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return _unit(rng, 3000, 16), _unit(rng, 40, 16)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_choose_serving_config_matches_reference():
    for target in (0.5, 0.9, 0.988, 0.9880000001, 0.99, 0.995, 0.999, 1.0):
        for k in (10, 100, 101):
            assert _fields(t_auto.choose_serving_config(target, k=k)) == \
                _fields(j_auto.choose_serving_config(target, k=k)), (target, k)
    assert [_fields(c) for c in t_auto._CURVE] == [_fields(c) for c in j_auto._CURVE]
    assert [c.cli_flags() for c in t_auto._CURVE] == [c.cli_flags() for c in j_auto._CURVE]
    for bad in (0.0, 1.5):
        for module in (t_auto, j_auto):
            with pytest.raises(ValueError, match=r"target_recall must be in \(0, 1\]"):
                module.choose_serving_config(bad)


@pytest.mark.parametrize("chunk", [512, 1000, 5000], ids=["tail", "tiled", "past-n"])
def test_exact_topk_streamed_matches_reference(data, chunk):
    corpus, queries = data
    want = j_auto._exact_topk_streamed(corpus, queries, 10, chunk, query_chunk=16)
    got = t_auto._exact_topk_streamed(corpus, queries, 10, chunk, query_chunk=16, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.argsort(-(queries @ corpus.T), axis=1)[:, :10])
    with pytest.raises(ValueError, match="at least k=10"):
        t_auto._exact_topk_streamed(corpus[:9], queries, 10, chunk, device="cpu")


def _plain_int8_curve(module):
    return (module.ServingConfig("int8", None, None, "int8", 0.9, "plain int8"), module._CURVE[-1])


@pytest.mark.parametrize("corpus_on", ["tensor", "host"])
@pytest.mark.parametrize("curve,target", [("default", 0.95), ("plain-int8", 0.999), ("plain-int8", 0.5)])
def test_calibrate_matches_reference(data, corpus_on, curve, target):
    """The default curve's first candidate meets 0.95; plain int8 at D = 16
    misses 0.999, so both fall back to the exact scan, and meets 0.5."""
    corpus, queries = data
    j_curve = j_auto._CURVE if curve == "default" else _plain_int8_curve(j_auto)
    t_curve = t_auto._CURVE if curve == "default" else _plain_int8_curve(t_auto)
    # the reference's "device array" branch is a jax.Array; its host branch numpy
    import jax.numpy as jnp

    j_corpus = jnp.asarray(corpus) if corpus_on == "tensor" else corpus
    t_corpus = torch.from_numpy(corpus) if corpus_on == "tensor" else corpus
    kw = dict(k=10, query_chunk=16, corpus_chunk=None if corpus_on == "tensor" else 700)
    want, want_measured = j_auto.calibrate_serving_config(target, j_corpus, queries, curve=j_curve, **kw)
    got, got_measured = t_auto.calibrate_serving_config(target, t_corpus, queries, curve=t_curve, device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert got_measured.keys() == want_measured.keys()
    for name, r in want_measured.items():
        assert abs(got_measured[name] - r) <= RECALL_ATOL, (name, got_measured[name], r)
    if curve == "plain-int8":
        assert (got.index_kind == "exact") == (target == 0.999)


def test_curve_without_exact_entry_raises(data):
    """Where no candidate meets the target and the curve has no exact entry
    the port raises ValueError; the reference asserts there
    (``jodalrob_twotower_tpu/serving/autoconfig.py:261``), which ``python -O``
    would skip."""
    corpus, queries = data
    t_curve = _plain_int8_curve(t_auto)[:1]
    with pytest.raises(ValueError, match="no exact entry"):
        t_auto.calibrate_serving_config(0.999, corpus, queries, k=10, curve=t_curve, device="cpu")
    with pytest.raises(AssertionError):
        j_auto.calibrate_serving_config(0.999, corpus, queries, k=10, curve=_plain_int8_curve(j_auto)[:1])
    with pytest.raises(ValueError, match=r"target_recall must be in \(0, 1\]"):
        t_auto.calibrate_serving_config(1.5, corpus, queries, k=10, device="cpu")


def test_overlap_recall_matches_reference():
    rng = np.random.default_rng(3)
    got, exact = rng.integers(0, 50, size=(20, 10)), rng.integers(0, 50, size=(20, 10))
    assert t_auto.overlap_recall(got, exact, 10) == j_auto.overlap_recall(got, exact, 10)
