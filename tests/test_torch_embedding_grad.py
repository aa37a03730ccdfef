"""The port's dense table gradient (K2's plain version) and the
differentiable lookups against the reference's Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerance: 1e-5 absolute. Both sides round g to bf16 and sum in f32; only
the order of the sums differs (the Pallas kernel sums by one-hot matmul,
the port in batch order), on sums of a few dozen values of magnitude <= 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.models.embedding import EmbeddingCollection, table_layout, tile_feature_map
from jodalrob_twotower_torch.ops import embedding_grad as teg
from jodalrob_twotower_tpu.ops import embedding_grad as jeg

VOCABS = (5, 130, 1000, 40)
D = 32
ATOL = 1e-5


def _rows(rng, b, *, ragged):
    offsets, total = table_layout(VOCABS)
    ids = np.stack([rng.integers(0, v, size=b) for v in VOCABS], axis=1)
    rows = ids + offsets[None, :]
    if ragged:  # ids of other features' blocks, alignment padding, -1, past the table
        other = rng.random(rows.shape) < 0.1
        rows[other] = rng.integers(0, total, size=int(other.sum()))
        pad = rng.random(rows.shape) < 0.05
        rows[pad] = (offsets + np.asarray([127, 255, 1023, 127]))[np.nonzero(pad)[1]]
        rows[rng.random(rows.shape) < 0.05] = -1
        rows[rng.random(rows.shape) < 0.02] = total + 5
    return rows.astype(np.int32), total


@pytest.mark.parametrize("b,ragged,skewed", [
    pytest.param(256, False, False, id="256-False"),
    pytest.param(300, True, False, id="300-True"),
    pytest.param(37, True, False, id="37-True"),
    # every id of a feature on one row, g of scale 0.01 (chip_smoke.py's skewed case)
    pytest.param(512, False, True, id="512-skewed"),
])
def test_plain_grad_matches_pallas(b, ragged, skewed):
    rng = np.random.default_rng(b)
    rows, total = _rows(rng, b, ragged=ragged)
    if skewed:
        rows = np.broadcast_to(table_layout(VOCABS)[0] + 3, rows.shape).astype(np.int32)
    g = rng.normal(0.0, 0.01 if skewed else 1.0, size=(b, len(VOCABS), D)).astype(np.float32)
    tf = tile_feature_map(VOCABS)
    want_t = jeg.dense_table_grad_t(
        jnp.asarray(rows), jnp.asarray(g), total_rows=total, tile_feature=tuple(tf.tolist()), interpret=True
    )
    want = jeg.dense_table_grad(
        jnp.asarray(rows), jnp.asarray(g), total_rows=total, tile_feature=tuple(tf.tolist()), interpret=True
    )
    got = teg.dense_table_grad(torch.from_numpy(rows), torch.from_numpy(g), torch.from_numpy(tf))
    assert got.dtype == torch.float32 and got.shape == (total, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_t).T, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_plain_grad_ignores_rows_outside_their_block():
    """An id in another feature's block, -1 and a row past the table add
    nothing; an id in its own block's alignment padding counts."""
    offsets, total = table_layout(VOCABS)
    tf = torch.from_numpy(tile_feature_map(VOCABS))
    rows = torch.tensor([[offsets[1], offsets[1] + 3, -1, total + 1]], dtype=torch.int32)
    g = torch.ones(1, 4, D)
    out = teg.dense_table_grad(rows, g, tf)
    assert out.sum().item() == D  # only feature 1's own id
    assert out[offsets[1] + 3].sum().item() == D
    pad = torch.tensor([[0, offsets[1] + 200, offsets[2], offsets[3]]], dtype=torch.int32)
    out = teg.dense_table_grad(pad, g, tf)
    assert out[offsets[1] + 200].sum().item() == D  # padding row of feature 1's block


@pytest.mark.parametrize("table_dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_onehot_lookup_grad_matches_jax(table_dtype):
    rng = np.random.default_rng(9)
    rows, total = _rows(rng, 64, ragged=True)
    rows = np.where(rows < 0, 0, np.minimum(rows, total - 1)).astype(np.int32)
    table = (rng.normal(size=(total, D)) / np.sqrt(D)).astype(np.float32)
    ct = rng.normal(size=(64, len(VOCABS), D)).astype(np.float32)
    tf = tile_feature_map(VOCABS)
    j_lookup = jeg.make_onehot_lookup(total, tuple(tf.tolist()), interpret=True)

    def j_loss(t):
        return jnp.sum(j_lookup(t, jnp.asarray(rows)).astype(jnp.float32) * ct)

    j_table = jnp.asarray(table).astype(table_dtype)
    want = jax.grad(j_loss)(j_table)
    t_dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[table_dtype]
    t_table = torch.from_numpy(table).to(t_dtype).requires_grad_(True)
    emb = teg.make_onehot_lookup(total, tf)(t_table, torch.from_numpy(rows))
    assert emb.dtype == torch.bfloat16 and emb.shape == (64, len(VOCABS), D)
    (emb.float() * torch.from_numpy(ct)).sum().backward()
    assert t_table.grad.dtype == t_dtype
    np.testing.assert_allclose(
        t_table.grad.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=0,
        atol=ATOL if table_dtype == jnp.float32 else 0.02,  # bf16 result: one ulp at |x| <= 4
    )


def test_dense_grad_lookup_matches_jax():
    rng = np.random.default_rng(10)
    rows, total = _rows(rng, 96, ragged=False)
    table = rng.normal(size=(total, D)).astype(np.float32)
    ct = rng.normal(size=(96, len(VOCABS), D)).astype(np.float32)
    tf = tile_feature_map(VOCABS)
    j_lookup = jeg.make_dense_grad_lookup(total, tuple(tf.tolist()), interpret=True)
    want_emb = j_lookup(jnp.asarray(table), jnp.asarray(rows))
    want = jax.grad(lambda t: jnp.sum(j_lookup(t, jnp.asarray(rows)) * ct))(jnp.asarray(table))
    t_table = torch.from_numpy(table).requires_grad_(True)
    emb = teg.make_dense_grad_lookup(total, tf)(t_table, torch.from_numpy(rows))
    assert emb.dtype == torch.float32
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(want_emb))
    (emb * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(t_table.grad.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "grad_mode,lookup_mode,dense",
    [("auto", "auto", False), ("dense", "auto", True), ("scatter", "auto", False), ("dense", "gather", True)],
)
def test_dense_grad_resolution_on_cpu(grad_mode, lookup_mode, dense):
    """On the CPU "auto" keeps the gather's scatter, as the reference does
    on its CPU backend; "dense" forces the table-gradient path."""
    coll = EmbeddingCollection((30, 40), 8, grad_mode=grad_mode, lookup_mode=lookup_mode)
    rows = torch.zeros(2, 2, dtype=torch.int32)
    assert coll._dense_grad_active(rows) is dense
    ids = torch.tensor([[1, 2], [3, 39]], dtype=torch.int32)
    coll.table.grad = None
    coll(ids).sum().backward()
    want = torch.zeros_like(coll.table)
    offsets, _ = table_layout((30, 40))
    for b in range(2):
        for k in range(2):
            want[offsets[k] + ids[b, k]] += 1.0
    torch.testing.assert_close(coll.table.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,k,d,ragged", [(256, 4, 32, False), (100, 3, 16, False), (300, 4, 32, True)])
def test_bmajor_plain_matches_pallas(b, k, d, ragged):
    """K3's plain version against the reference's ``dense_table_grad_bmajor``
    in interpret mode (tests/test_embedding_grad.py:294-320) and against
    K2's plain version transposed, bit for bit; the CPU wrapper takes the
    plain version without launching."""
    rng = np.random.default_rng(b + k)
    if ragged:
        rows, total = _rows(rng, b, ragged=True)
        vocabs = VOCABS
    else:
        vocabs = tuple(rng.integers(50, 200, size=k).tolist())
        offsets, total = table_layout(vocabs)
        rows = (np.stack([rng.integers(0, v, size=b) for v in vocabs], axis=1) + offsets[None, :]).astype(np.int32)
    g = rng.normal(size=(b, len(vocabs), d)).astype(np.float32)
    tf = tile_feature_map(vocabs)
    want = jeg.dense_table_grad_bmajor(
        jnp.asarray(rows), jnp.asarray(g), total_rows=total, tile_feature=tuple(tf.tolist()), interpret=True
    )
    args = (torch.from_numpy(rows), torch.from_numpy(g), torch.from_numpy(tf))
    before = teg.dense_table_grad_bmajor.launches
    got = teg.dense_table_grad_bmajor(*args)
    assert teg.dense_table_grad_bmajor.launches == before
    assert got.dtype == torch.float32 and got.shape == (d, total) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert torch.equal(got, teg.dense_table_grad_plain(*args).t())
    assert torch.equal(got, teg.dense_table_grad_bmajor_plain(*args))


@pytest.mark.parametrize("b,total_rows", [(37, 32768), (1000, 32768), (8192, 6144), (8192, 32768), (8192, 65536),
                                          (65536, 128), (0, 1024), (1 << 20, 1 << 20)])
def test_cluster_choice_is_a_pure_function_of_the_shape(b, total_rows):
    """The table gradient's cluster size C (CTAs per tile): a power of two
    at most the portable 8, 1 for small batches, the same at the same shape,
    and a grid of C CTAs for each 128-row tile."""
    c, grid = teg.table_grad_launch_shape(b, total_rows)
    assert c in (1, 2, 4, 8) and c <= teg.MAX_CLUSTER
    assert (c, grid) == teg.table_grad_launch_shape(b, total_rows)
    assert grid % c == 0 and grid == c * (total_rows // teg.TILE_ROWS)
    if b < 2 * teg.CLUSTER_IDS:
        assert c == 1
    if c > 1:  # every CTA keeps enough ids to scan, and the grid stays within its bound
        assert c * teg.CLUSTER_IDS <= b and grid <= teg.CLUSTER_MAX_CTAS


def test_cluster_choice_at_the_training_shapes():
    """C > 1 at both of the training path's shapes (B = 8192: the notice
    table of 32,768 rows and the company table of 6,144), 1 at B = 37 and
    at the dense envelope's edge (R = 65,536), whose 512 tiles fill the card."""
    assert teg.table_grad_launch_shape(37, 32768) == (1, 256)
    assert teg.table_grad_launch_shape(8192, 32768) == (2, 512)
    assert teg.table_grad_launch_shape(8192, 6144) == (4, 192)
    assert teg.table_grad_launch_shape(8192, 65536) == (1, 512)
