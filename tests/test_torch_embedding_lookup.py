"""The port's one-hot lookup (kernel K1's plain version and wrapper) against
the JAX package's Pallas kernel in interpret mode, plus the unified-table
layout helpers. The CUDA kernel itself runs only on the card, where
chip_smoke.py holds it bit-exact against the same plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import ModelConfig as TorchModelConfig
from jodalrob_twotower_torch.models import embedding as t_emb
from jodalrob_twotower_torch.ops import _build
from jodalrob_twotower_torch.ops.embedding_grad import (
    dense_table_lookup,
    dense_table_lookup_plain,
    make_onehot_lookup as t_make_onehot_lookup,
)
from jodalrob_twotower_torch.ops.embedding_lookup import embedding_lookup
from jodalrob_twotower_tpu.config import ModelConfig as JaxModelConfig
from jodalrob_twotower_tpu.models import embedding as j_emb
from jodalrob_twotower_tpu.ops.embedding_grad import make_onehot_lookup as j_make_onehot_lookup

VOCABS = (5, 130, 1000)


def _ragged_rows(rng, b):
    """Absolute rows with in-block ids (alignment padding included), rows
    of other features' blocks, -1 padding and rows past the table."""
    offsets, total_rows = t_emb.table_layout(VOCABS)
    aligned = [-(-v // 128) * 128 for v in VOCABS]
    rows = np.stack([rng.integers(0, a, size=b) for a in aligned], axis=1) + offsets[None, :]
    other = rng.random(rows.shape) < 0.15
    rows[other] = rng.integers(0, total_rows, size=int(other.sum()))
    rows[rng.random(rows.shape) < 0.1] = -1
    rows[rng.random(rows.shape) < 0.05] = total_rows + 7
    return rows.astype(np.int32), total_rows


@pytest.mark.parametrize(
    "b,d,dtype", [(200, 16, "float32"), (77, 32, "bfloat16"), (300, 8, "float32")]
)
def test_plain_lookup_bit_equal_to_pallas_interpret(b, d, dtype):
    rng = np.random.default_rng(b)
    rows, total_rows = _ragged_rows(rng, b)
    tf = t_emb.tile_feature_map(VOCABS)
    table = rng.normal(size=(total_rows, d)).astype(np.float32)
    jax_table = jnp.asarray(table, getattr(jnp, dtype))
    want = j_make_onehot_lookup(total_rows, tuple(tf.tolist()), interpret=True)(
        jax_table, jnp.asarray(rows)
    )
    torch_table = torch.from_numpy(table).to(getattr(torch, dtype))
    got = dense_table_lookup_plain(torch_table, torch.from_numpy(rows), torch.from_numpy(tf))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, len(VOCABS), d)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # the rows that are out of their block really are zero (not just equal)
    in_block = (rows >= 0) & (rows < total_rows)
    in_block &= tf[np.clip(rows, 0, total_rows - 1) // 128] == np.arange(len(VOCABS))
    assert not got.float().numpy()[~in_block].any()


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    rng = np.random.default_rng(0)
    rows, total_rows = _ragged_rows(rng, 64)
    table = torch.from_numpy(rng.normal(size=(total_rows, 8)).astype(np.float32))
    tf = torch.from_numpy(t_emb.tile_feature_map(VOCABS))
    before = dense_table_lookup.launches
    got = dense_table_lookup(table, torch.from_numpy(rows), tf)
    assert dense_table_lookup.launches == before
    assert torch.equal(got, dense_table_lookup_plain(table, torch.from_numpy(rows), tf))
    lookup = t_make_onehot_lookup(total_rows, tf.numpy())
    assert torch.equal(lookup(table, torch.from_numpy(rows)), got)


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda t, r, f: (t.double(), r, f), "float32 or bfloat16"),
        (lambda t, r, f: (t, r.long(), f), "int32"),
        (lambda t, r, f: (t, r, f[:-1]), "tile_feature"),
        (lambda t, r, f: (t, r, f.long()), "tile_feature must be int32"),
        (lambda t, r, f: (t[:, :4].contiguous(), r, f), "multiple of 8"),
        (lambda t, r, f: (t, r.t().contiguous().t(), f), "contiguous"),
        (lambda t, r, f: (t[:-128], r, f), "tile_feature"),
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, match):
    _, total_rows = t_emb.table_layout(VOCABS)
    table = torch.zeros(total_rows, 16)
    rows = torch.zeros(10, len(VOCABS), dtype=torch.int32)
    tf = torch.from_numpy(t_emb.tile_feature_map(VOCABS))
    with pytest.raises(ValueError, match=match):
        dense_table_lookup(*mutate(table, rows, tf))


def test_make_onehot_lookup_rejects_wrong_tile_map():
    with pytest.raises(ValueError, match="one entry per"):
        t_make_onehot_lookup(256, np.zeros(3, np.int32))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc (a machine with no CUDA toolkit) the build raises a clear error;
    the flags target sm_90a, and the library name follows the source."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path("onehot_lookup").name.startswith("onehot_lookup-")


def test_layout_helpers_match_reference():
    for vocabs in [VOCABS, (1,), (128, 129, 3)]:
        for a, b in zip(t_emb.table_layout(vocabs), j_emb.table_layout(vocabs)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_emb.tile_feature_map(vocabs), j_emb.tile_feature_map(vocabs))
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(-5, 2 * v, size=50) for v in VOCABS], axis=1).astype(np.int32)
    np.testing.assert_array_equal(
        t_emb.absolute_rows(VOCABS, torch.from_numpy(ids)).numpy(),
        np.asarray(j_emb.absolute_rows(VOCABS, jnp.asarray(ids))),
    )
    # the plain gather is the reference's jnp.take
    table = rng.normal(size=(t_emb.table_layout(VOCABS)[1], 8)).astype(np.float32)
    rows = t_emb.absolute_rows(VOCABS, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        embedding_lookup(torch.from_numpy(table), rows).numpy(),
        np.take(table, rows.numpy(), axis=0),
    )


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"compute_dtype": "float32"},
        {"compute_dtype": "float32", "embedding_lookup": "onehot"},
        {"embedding_lookup": "gather"},
        {"embedding_lookup": "onehot"},
    ],
)
def test_resolve_lookup_mode_matches_reference(kw):
    assert t_emb.resolve_lookup_mode(TorchModelConfig(**kw)) == j_emb.resolve_lookup_mode(
        JaxModelConfig(**kw)
    )


def test_auto_gate_takes_the_gather_on_cpu():
    """"auto" runs the kernel only for CUDA tensors; on the CPU it gathers
    (float32 out), while forced "onehot" runs the plain version (bf16 out)."""
    ids = torch.zeros(4, len(VOCABS), dtype=torch.int32)
    auto = t_emb.EmbeddingCollection(VOCABS, 8)
    forced = t_emb.EmbeddingCollection(VOCABS, 8, lookup_mode="onehot")
    forced.load_state_dict(auto.state_dict())
    with torch.no_grad():
        a, f = auto(ids), forced(ids)
    assert a.dtype == torch.float32 and f.dtype == torch.bfloat16
    assert torch.equal(a.to(torch.bfloat16), f)
