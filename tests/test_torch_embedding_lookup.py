"""The port's one-hot lookup (kernel K1's plain version and wrapper) and row
gather (kernel K4's plain version, wrapper and differentiable lookup)
against the JAX package's Pallas kernels in interpret mode, plus the
unified-table layout helpers. The CUDA kernels themselves run only on the
card, where chip_smoke.py holds them bit-exact against the same plain
versions. K4's backward is a scatter-add outside the kernel: within 1e-6
of the reference's ``_lookup_bwd`` for a float32 table (sums of a few
duplicates, another order); for a bfloat16 table, whose sums run in
bfloat16 and round at every add, within n bf16 ulps (n 2^-8 of the largest
entry) where n is the most occurrences of one row."""

import importlib

import jax
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
from jodalrob_twotower_torch.ops import embedding_lookup as t_el
from jodalrob_twotower_torch.ops.embedding_lookup import embedding_lookup
from jodalrob_twotower_tpu.config import ModelConfig as JaxModelConfig
from jodalrob_twotower_tpu.models import embedding as j_emb
from jodalrob_twotower_tpu.ops.embedding_grad import make_onehot_lookup as j_make_onehot_lookup

# the module, not the function of the same name the package re-exports
j_el = importlib.import_module("jodalrob_twotower_tpu.ops.embedding_lookup")

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


@pytest.mark.parametrize(
    "shape,d,dtype", [((300,), 64, "float32"), ((37, 5), 16, "bfloat16"), ((8, 4, 3), 8, "float32")],
    ids=["f32-300", "bf16-37x5", "f32-8x4x3"],
)
def test_k4_plain_bit_equal_to_pallas_interpret(shape, d, dtype):
    """K4's plain version (and the CPU wrapper) gathers in the table's dtype
    for rows of any shape, lengths that are not multiples of the TPU's 256
    ids per program included, bit for bit as the Pallas kernel."""
    rng = np.random.default_rng(d)
    table = rng.normal(size=(700, d)).astype(np.float32)
    rows = rng.integers(0, 700, size=shape).astype(np.int32)
    jt = jnp.asarray(table, getattr(jnp, dtype))
    want = np.asarray(j_el.embedding_lookup_pallas(jt, jnp.asarray(rows), interpret=True).astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    before = t_el.embedding_lookup_pallas.launches
    got = t_el.embedding_lookup_pallas(tt, torch.from_numpy(rows))
    assert t_el.embedding_lookup_pallas.launches == before
    assert got.dtype == tt.dtype and tuple(got.shape) == (*shape, d)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, t_el.embedding_lookup_pallas_plain(tt, torch.from_numpy(rows)))


def test_k4_clamps_rows_outside_the_table():
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    rows = torch.tensor([[-1, 0], [9, 12]], dtype=torch.int32)
    got = t_el.embedding_lookup_pallas(table, rows)
    assert torch.equal(got, table[torch.tensor([[0, 0], [9, 9]])])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_backward_matches_lookup_bwd(dtype):
    """The differentiable lookup's table gradient on rows with duplicates
    against the reference's ``_lookup_bwd`` called directly: zeros of the
    table's shape and dtype, g cast to that dtype before the scatter-add."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    rows = rng.integers(0, 20, size=(64, 3)).astype(np.int32)  # heavy duplicates
    g = rng.normal(size=(64, 3, 16)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want, _ = j_el._lookup_bwd(((50, 16), jdt, jnp.asarray(rows)), jnp.asarray(g))
    want = np.asarray(want.astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_(True)
    out = embedding_lookup(tt, torch.from_numpy(rows), use_pallas=True)
    assert out.dtype == tt.dtype and out.shape == (64, 3, 16)
    out.backward(torch.from_numpy(g).to(out.dtype))
    assert tt.grad.dtype == tt.dtype
    # each bf16 add rounds: two orders of a row's n adds differ by up to n
    # half-ulps each way, at most n ulps (2^-8 relative) of the largest sum
    most = int(np.bincount(rows.reshape(-1)).max())
    atol = 1e-6 if dtype == "float32" else most * 2.0**-8 * float(np.abs(want).max())
    np.testing.assert_allclose(tt.grad.float().numpy(), want, rtol=0, atol=atol)


def test_collection_use_pallas_matches_jax_collection():
    """EmbeddingCollection(use_pallas=True) on the CPU (the gather path:
    neither the one-hot lookup nor the dense gradient applies there) against
    the reference's collection with use_pallas=False, the same function
    (the reference's use_pallas=True runs only in interpret mode on a CPU):
    the forward bit for bit, the table gradient within 1e-6."""
    rng = np.random.default_rng(6)
    coll = t_emb.EmbeddingCollection(VOCABS, 8, use_pallas=True)
    ids = np.stack([rng.integers(-2, v + 3, size=40) for v in VOCABS], axis=1).astype(np.int32)
    ct = rng.normal(size=(40, len(VOCABS) * 8)).astype(np.float32)
    j_coll = j_emb.EmbeddingCollection(vocab_sizes=VOCABS, embed_dim=8, use_pallas=False)
    table = rng.normal(size=tuple(coll.table.shape)).astype(np.float32)
    with torch.no_grad():
        coll.table.copy_(torch.from_numpy(table))

    def j_loss(t):
        return jnp.sum(j_coll.apply({"params": {"table": t}}, jnp.asarray(ids)) * ct)

    want_out = np.asarray(j_coll.apply({"params": {"table": jnp.asarray(table)}}, jnp.asarray(ids)))
    want_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(table)))
    out = coll(torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(coll.table.grad.numpy(), want_grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "table,rows,match",
    [
        (torch.zeros(10, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), "float32 or bfloat16"),
        (torch.zeros(10, 4), torch.zeros(3), "int32 or int64"),
        (torch.zeros(10), torch.zeros(3, dtype=torch.int32), r"\[R, D\]"),
    ],
)
def test_k4_wrapper_rejects_bad_inputs(table, rows, match):
    with pytest.raises(ValueError, match=match):
        t_el.embedding_lookup_pallas(table, rows)
