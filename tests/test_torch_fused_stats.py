"""The port's statistics kernels (K8 ``same_tile_diag``, K5/K9
``fused_stats_sweep``) and the col-blocked range of the CE kernels (K7
``fused_lean_lse``, K10 ``fused_ce_bwd`` past B = 8192) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs:
unit-norm rows with each positive from near its row to nearly random, so
|S| <= 1/tau as in training and the ranks spread.

The blocked reference kernels run at B = 1024 with their column block cut to
256 (``monkeypatch`` on the JAX module's ``_BN_BLOCKED``, as
tests/test_fused_logits.py does), so the column sweep has four blocks; the
port's envelope is cut the same way, so its dispatch takes the blocked
route. On the CPU the port runs the kernels' plain versions.

Tolerances (both sides take bf16 operands with f32 sums; only the order of
the sums differs): lse and the diagonal 5e-6 absolute, the row and column
sums 1e-4 absolute (sums of B values up to 1/tau in magnitude), ranks equal.
dn/dc and the gradients 1e-4 of their largest entry, the loss 1e-5, as in
tests/test_torch_fused_logits.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.ops import fused_logits as tfl
from jodalrob_twotower_tpu.ops import fused_logits as jfl

D = 128
LSE_ATOL = 5e-6
SUM_ATOL = 1e-4


def _pair(b: int, seed: int):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    n = unit(rng.normal(size=(b, D)))
    # positives from near their row to nearly random, so ranks spread from 0 to tens
    noise = rng.uniform(0.5, 12.0, size=(b, 1))
    return n, unit(n + noise * unit(rng.normal(size=(b, D))))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _check_stats(got_rows, got_cols, want_rows, want_cols):
    got_rows, got_cols = np.asarray(got_rows), np.asarray(got_cols)
    want_rows, want_cols = np.asarray(want_rows), np.asarray(want_cols)
    assert got_rows.shape == want_rows.shape and got_cols.shape == want_cols.shape
    np.testing.assert_allclose(got_rows[:, 0], want_rows[:, 0], rtol=0, atol=LSE_ATOL)  # row lse
    np.testing.assert_allclose(got_rows[:, 1], want_rows[:, 1], rtol=0, atol=SUM_ATOL)  # row sum
    np.testing.assert_allclose(got_rows[:, 2], want_rows[:, 2], rtol=0, atol=LSE_ATOL)  # diag
    np.testing.assert_array_equal(got_rows[:, 3], want_rows[:, 3])  # rank
    np.testing.assert_allclose(got_cols[0], want_cols[0], rtol=0, atol=LSE_ATOL)  # col lse
    np.testing.assert_allclose(got_cols[1], want_cols[1], rtol=0, atol=SUM_ATOL)  # col sum


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_k5_stats_match_pallas(tau):
    n, c = _pair(256, 11)
    n_scaled = n / np.float32(tau)
    want_rows, want_cols = jfl._fused_stats_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True)
    assert np.asarray(want_rows)[:, 3].max() > 0  # ranks are not all 0: the check has teeth
    # the dispatcher (diagonal from the same S) and the two kernel wrappers
    stats = tfl.fused_stats(torch.from_numpy(n), torch.from_numpy(c), temperature=tau)
    _check_stats(
        torch.stack([stats.row_lse, stats.row_sum, stats.diag, stats.rank], 1), torch.stack([stats.col_lse, stats.col_sum]),
        want_rows, want_cols,
    )
    nt, ct = torch.from_numpy(n_scaled), torch.from_numpy(c)
    got_rows, got_cols = tfl.fused_stats_sweep(nt, ct, tfl.same_tile_diag(nt, ct))
    _check_stats(got_rows, got_cols, want_rows, want_cols)


def test_k5_stats_row_offset_matches_pallas():
    """A row shard (rows 128..256 of B = 256) against all of C: the
    diagonal sits at column row + 128; the column statistics cover the
    shard's rows."""
    n, c = _pair(256, 12)
    n_scaled = (n / np.float32(0.3))[128:]
    want_rows, want_cols = jfl._fused_stats_call(
        jnp.asarray(n_scaled), jnp.asarray(c), jnp.int32(128), interpret=True
    )
    nt, ct = torch.from_numpy(n_scaled), torch.from_numpy(c)
    got_rows, got_cols = tfl.fused_stats_sweep(nt, ct, tfl.same_tile_diag(nt, ct, 128), 128)
    _check_stats(got_rows, got_cols, want_rows, want_cols)


@pytest.mark.parametrize("row_offset", [0, 128])
def test_k8_same_tile_diag_matches_pallas(row_offset):
    n, c = _pair(256, 13)
    n_scaled = n / np.float32(0.3)
    rows = slice(row_offset, 256) if row_offset else slice(0, 256)
    nb = jnp.asarray(n_scaled[rows]).astype(jnp.bfloat16)
    cb = jnp.asarray(c).astype(jnp.bfloat16)[row_offset : row_offset + nb.shape[0]]
    want = np.asarray(jfl._diag_mxu_call(nb, cb, interpret=True))[:, 0]
    got = tfl.same_tile_diag(torch.from_numpy(n_scaled[rows]), torch.from_numpy(c), row_offset)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LSE_ATOL)


@pytest.fixture
def blocked_envelope(monkeypatch):
    """Both packages' col-blocked envelope opened at B = 1024 (the
    reference's column block 256)."""
    monkeypatch.setattr(jfl, "_MAX_B", 256)
    monkeypatch.setattr(jfl, "_BN_BLOCKED", 256)
    monkeypatch.setattr(tfl, "_MAX_B", 256)
    monkeypatch.setattr(tfl, "_BN_BLOCKED", 256)
    assert jfl._blocked_supported(1024, 1024, D) and tfl._blocked_supported(1024, D)
    assert not tfl._supported(1024, D)


def test_k9_blocked_stats_match_pallas(blocked_envelope):
    n, c = _pair(1024, 14)
    tau = 0.3
    want_rows, want_cols = jfl._fused_stats_blocked_call(jnp.asarray(n / np.float32(tau)), jnp.asarray(c), interpret=True)
    stats = tfl.fused_stats(torch.from_numpy(n), torch.from_numpy(c), temperature=tau)
    _check_stats(
        torch.stack([stats.row_lse, stats.row_sum, stats.diag, stats.rank], 1), torch.stack([stats.col_lse, stats.col_sum]),
        want_rows, want_cols,
    )


@pytest.mark.parametrize("nomax", [True, False], ids=["nomax", "shifted"])
def test_k7_blocked_lean_lse_matches_pallas(blocked_envelope, nomax):
    n, c = _pair(1024, 15)
    tau = 0.3
    n_scaled = n / np.float32(tau)
    want_r, want_c = jfl._fused_lean_blocked_call(
        jnp.asarray(n_scaled), jnp.asarray(c), interpret=True, max_abs_logit=(1.0 / tau) if nomax else None
    )
    got_r, got_c = tfl.fused_lean_lse(torch.from_numpy(n_scaled), torch.from_numpy(c), nomax=nomax)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0, atol=LSE_ATOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_k10_blocked_bwd_matches_pallas(blocked_envelope, eps):
    n, c = _pair(1024, 16)
    n_scaled = n / np.float32(0.3)
    rl, cl = jfl._fused_lean_blocked_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True)
    want_dn, want_dc = jfl._fused_bwd_blocked_call(jnp.asarray(n_scaled), jnp.asarray(c), rl, cl, eps, interpret=True)
    got_dn, got_dc = tfl.fused_ce_bwd(
        torch.from_numpy(n_scaled), torch.from_numpy(c), torch.from_numpy(np.array(rl)),
        torch.from_numpy(np.array(cl)), eps,
    )
    assert _rel(got_dn.numpy(), want_dn) < 1e-4
    assert _rel(got_dc.numpy(), want_dc) < 1e-4


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_blocked_loss_and_grads_match_jax(blocked_envelope, eps):
    """The whole B > 8192 loss at small scale: without label smoothing the
    lean forward (K7) and the blocked backward (K10), with it the blocked
    statistics forward (K8 + K9) and K10."""
    n, c = _pair(1024, 17)
    tau = 0.3
    assert tfl.ce_route(1024, D, eps) == ("kernel" if eps == 0 else "stats")

    def jax_loss(nn_, cc):
        return jfl.fused_bidirectional_ce(nn_, cc, tau, eps, True, 1.0 / tau)

    want_loss, (want_dn, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(n), jnp.asarray(c))
    n_t = torch.from_numpy(n).requires_grad_(True)
    c_t = torch.from_numpy(c).requires_grad_(True)
    loss = tfl.fused_bidirectional_ce(n_t, c_t, tau, eps, 1.0 / tau)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-5)
    assert _rel(n_t.grad.numpy(), want_dn) < 1e-4
    assert _rel(c_t.grad.numpy(), want_dc) < 1e-4


def test_fused_in_batch_metrics_match_pallas():
    """The eval metrics from the port's statistics against the reference's
    ``fused_in_batch_metrics`` on its stats kernel (interpret mode)."""
    n, c = _pair(256, 18)
    want = jfl.fused_in_batch_metrics(jnp.asarray(n), jnp.asarray(c), temperature=0.3, interpret=True)
    got = tfl.fused_in_batch_metrics(torch.from_numpy(n), torch.from_numpy(c), temperature=0.3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_stats_outside_the_envelope_are_materialized_f32():
    """B = 100 fits no kernel: both sides take the f32 statistics of the
    materialized matrix."""
    n, c = _pair(100, 19)
    want = jfl.fused_stats(jnp.asarray(n), jnp.asarray(c), temperature=0.5, interpret=True)
    got = tfl.fused_stats(torch.from_numpy(n), torch.from_numpy(c), temperature=0.5)
    for field in ("row_lse", "row_sum", "diag", "col_lse", "col_sum"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))


def test_kernel_wrappers_check_their_operands():
    n, c = _pair(256, 20)
    nt, ct = torch.from_numpy(n), torch.from_numpy(c)
    with pytest.raises(ValueError, match="row_offset"):
        tfl.same_tile_diag(nt[:128], ct, 192)
    with pytest.raises(ValueError, match="diag"):
        tfl.fused_stats_sweep(nt, ct, torch.zeros(255))
    with pytest.raises(ValueError, match="n .rows, D. and c"):
        tfl.fused_stats_sweep(nt, ct[:, :64], torch.zeros(256))


def _unit_ranges(units: int, ctas: int) -> np.ndarray:
    """CTA k's units [k U / G, (k + 1) U / G), as the sweep splits them."""
    return np.arange(ctas + 1, dtype=np.int64) * units // ctas


@pytest.mark.parametrize("d", [128, 256, 512, 1024])
@pytest.mark.parametrize("b", [1024, 8192, 16384, 65536])
def test_stats_launch_shape(b, d):
    """The statistics sweep's split at every envelope shape (rows = B): up to
    D = 512 every unit (a 64-row tile against a block of W 64-column slices)
    lies in exactly one CTA's range; a column's partials are the CTAs whose
    ranges meet its block, in CTA order (piece p of block x from CTA
    first(x) + p), at most col_parts of them; a row merges one partial per 64
    columns; the workspace holds a float4 per partial. Past D = 512 one
    block per 64 rows with three [rows / 64, B] planes. The shape is a pure
    function of (rows, B, D)."""
    shape = tfl.stats_launch_shape(b, b, d)
    assert shape == tfl.stats_launch_shape(b, b, d)
    if d > 512:
        assert shape == tfl.StatsLaunch(b // 64, b, 0, b // 64, 3 * (b // 64) * b)
        return
    consumers = 3 if d <= 256 else 2
    assert shape.block_cols == 64 * consumers and shape.row_parts == b // 64
    n_x, n_y = -(-b // shape.block_cols), b // 64
    units = n_x * n_y
    assert shape.ctas == min(132, units)
    starts = _unit_ranges(units, shape.ctas)
    covered = np.zeros(units, dtype=np.int64)
    for k in range(shape.ctas):
        assert starts[k + 1] > starts[k]
        covered[starts[k] : starts[k + 1]] += 1
    assert (covered == 1).all()
    owner = np.repeat(np.arange(shape.ctas), np.diff(starts))  # the CTA of each unit
    parts = 0
    for x in range(n_x):
        ctas = owner[x * n_y : (x + 1) * n_y]
        meeting = np.unique(ctas)
        # in unit order the block's CTAs come in CTA order, each once, with no gap
        assert (np.diff(ctas) >= 0).all() and (meeting == np.arange(meeting[0], meeting[-1] + 1)).all()
        parts = max(parts, meeting.size)
    assert shape.col_parts == parts
    assert shape.workspace_floats == 4 * (shape.row_parts * b + shape.col_parts * b)


def test_stats_workspace_sizes_in_the_docstring():
    """The sizes ``fused_stats_sweep``'s docstring gives at D = 128: 16.6 MiB
    at B = 8192 and 1026 MiB at 65536 (the mma.sync sweep's [3, B/64, B]
    planes were 12 and 768 MiB)."""
    got = [tfl.stats_launch_shape(b, b, 128).workspace_floats * 4 / 2**20 for b in (8192, 65536)]
    assert round(got[0], 1) == 16.6 and round(got[1]) == 1026
    assert "16.6 MiB at B = 8192, 1026 MiB at 65536" in " ".join(tfl.fused_stats_sweep.__doc__.split())


@pytest.mark.parametrize("rows", [1024, 256, 64])
def test_stats_launch_shape_of_a_row_shard(rows):
    """A row shard of N against all of C (the kernel takes its row_offset
    apart from the split): the split covers its rows / 64 tiles in every
    block, and a row still merges one partial per 64 columns of C."""
    b = 1024
    shape = tfl.stats_launch_shape(rows, b, 128)
    n_x, n_y = -(-b // shape.block_cols), rows // 64
    assert shape.ctas == min(132, n_x * n_y) and shape.row_parts == b // 64
    assert shape.workspace_floats == 4 * (shape.row_parts * rows + shape.col_parts * b)
