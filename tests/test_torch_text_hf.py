"""The port's ``HFTextEmbedder`` against the JAX package's, with the fake
tokenizer and model of tests/test_text_hf.py in place of transformers'
factories (nothing is downloaded): on ``device="cpu"`` both pool to within
1e-6. Without a card, ``HFTextEmbedder()`` raises before it loads anything,
and ``TextPreprocessor`` lets that error through; it falls back to the hash
embedder only when the model cannot be loaded."""

import sys

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.etl import text as ttext
from jodalrob_twotower_tpu.etl import text as jtext
from test_text_hf import _FakeModel, _FakeTokenizer

no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")


@pytest.fixture()
def fake_hf(monkeypatch):
    import transformers

    tok = _FakeTokenizer()
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda name: tok)
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", lambda name: _FakeModel())
    return tok


@pytest.fixture()
def unloadable_hf(monkeypatch):
    """transformers' factories failing as they do offline, without a cache."""
    import transformers

    def offline(name):
        raise OSError(f"We couldn't connect to load {name} (offline)")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", offline)
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", offline)


TEXTS = ["aa bb ccc", "x", "one two three four five six", "", "  Hello World  ", "hello world", "공사 용역 notice"]


@pytest.mark.parametrize("cfg", [dict(max_length=4, batch_size=2), dict(max_length=2, normalize=False),
                                 dict(lowercase=True, batch_size=3), dict(strip=False, max_length=32)])
def test_hf_embedder_matches_the_reference(fake_hf, cfg):
    got = ttext.HFTextEmbedder(model_name="fake/model", device="cpu")
    want = jtext.HFTextEmbedder(model_name="fake/model", device="cpu")
    assert got.device == torch.device("cpu") and got.embed_dim == want.embed_dim
    g = got.encode(TEXTS, ttext.TextColumnConfig(**cfg))
    w = want.encode(TEXTS, jtext.TextColumnConfig(**cfg))
    assert g.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_text_preprocessor_with_the_hf_embedder_matches_the_reference(fake_hf):
    table = {"title": np.asarray(["hello world", None, float("nan"), "ok"], object)}
    cfg = {"title": {"max_length": 8, "add_flag": True}}
    got = ttext.TextPreprocessor(cfg, embedder=ttext.HFTextEmbedder("fake/model", "cpu")).transform(table)
    want = jtext.TextPreprocessor(cfg, embedder=jtext.HFTextEmbedder("fake/model", "cpu")).transform(table)
    np.testing.assert_array_equal(got["title_is_null"], want["title_is_null"])
    np.testing.assert_allclose(got["title"], want["title"], rtol=0, atol=1e-6)


@no_card
def test_hf_embedder_without_a_card_raises_before_loading(fake_hf):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttext.HFTextEmbedder(model_name="fake/model")
    assert fake_hf.calls == []


@no_card
def test_text_preprocessor_does_not_swallow_the_missing_card(fake_hf):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttext.TextPreprocessor({"title": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttext.auto_text_embedder("fake/model")


def test_falls_back_to_the_hash_embedder_when_the_model_cannot_load(unloadable_hf):
    emb = ttext.auto_text_embedder("fake/model", "cpu", embed_dim=24)
    assert isinstance(emb, ttext.HashTextEmbedder) and emb.embed_dim == 24
    got = emb.encode(TEXTS, ttext.TextColumnConfig())
    np.testing.assert_array_equal(got, jtext.HashTextEmbedder(24).encode(TEXTS, jtext.TextColumnConfig()))


def test_falls_back_to_the_hash_embedder_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import fails
    assert isinstance(ttext.auto_text_embedder(None, "cpu", embed_dim=8), ttext.HashTextEmbedder)
