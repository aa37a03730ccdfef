"""The port's fused in-batch CE (K6 forward, K11 backward and the autograd
wrapper) against the reference's Pallas kernels in interpret mode, on the
same numpy inputs: unit-norm rows, so |S| <= 1/tau as in training.

Tolerances: the lse values 5e-6 (both sides take bf16 operands with f32
sums; only the order of the sums differs, about 1e-6 measured). dn/dc and
the gradients 1e-4 of their largest entry: A is rounded to bf16 before the
contractions, and an A entry that lies on a rounding boundary can round one
bf16 ulp (2^-8 of itself) apart when its exp was summed in another order
(about 1e-6 measured, with no such entry at these inputs). The loss 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.ops import fused_logits as tfl
from jodalrob_twotower_tpu.ops import fused_logits as jfl

B, D = 256, 128


def _unit_rows(rng, b, d):
    x = rng.normal(size=(b, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    n = _unit_rows(rng, B, D)
    # positives close to their rows, so the diagonal matters
    c = _unit_rows(rng, B, D) * 0.5 + n
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    return n, c


@pytest.fixture
def pinned_numerics():
    """Pins, for the test, the state a test run earlier in the same process
    could leave changed: the reference's matmul precision (the session's
    "highest") and the port's float32 matmul precision and thread count (one
    thread: no split of the product over threads). The reference's CPU
    thread pool is fixed when its backend starts and cannot be pinned here."""
    precision, threads = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("tau", [1.0, 0.1])
@pytest.mark.parametrize("nomax", [True, False], ids=["nomax", "shifted"])
def test_lean_lse_matches_pallas(pair, tau, nomax, pinned_numerics):
    n, c = pair
    n_scaled = n / np.float32(tau)
    want_r, want_c = jfl._fused_lean_call(
        jnp.asarray(n_scaled), jnp.asarray(c), interpret=True,
        max_abs_logit=(1.0 / tau) if nomax else None,
    )
    got_r, got_c = tfl.fused_lean_lse(torch.from_numpy(n_scaled), torch.from_numpy(c), nomax=nomax)
    assert got_r.dtype == torch.float32 and got_r.shape == (B,) and got_c.shape == (B,)
    # on a mismatch, say which side left the exact value (float64 from the same bf16 operands)
    s64 = torch.from_numpy(n_scaled).to(torch.bfloat16).double() @ torch.from_numpy(c).to(torch.bfloat16).double().T
    for got, want, exact in ((got_r, want_r, torch.logsumexp(s64, 1)), (got_c, want_c, torch.logsumexp(s64, 0))):
        side = (f"port max |err| vs float64 {float((got.double() - exact).abs().max()):.3g}, reference "
                f"{float(np.abs(np.asarray(want, np.float64) - exact.numpy()).max()):.3g}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6, err_msg=side)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("tau", [1.0, 0.1])
def test_bwd_matches_pallas(pair, tau, eps):
    n, c = pair
    n_scaled = n / np.float32(tau)
    row_lse, col_lse = jfl._fused_lean_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True)
    want_dn, want_dc = jfl._fused_bwd_call(
        jnp.asarray(n_scaled), jnp.asarray(c), row_lse, col_lse, eps, interpret=True
    )
    got_dn, got_dc = tfl.fused_ce_bwd(
        torch.from_numpy(n_scaled), torch.from_numpy(c),
        torch.from_numpy(np.array(row_lse)), torch.from_numpy(np.array(col_lse)), eps,
    )
    assert got_dn.shape == (B, D) and got_dc.shape == (B, D) and got_dn.dtype == torch.float32
    assert _rel(got_dn.numpy(), want_dn) < 1e-4
    assert _rel(got_dc.numpy(), want_dc) < 1e-4


def test_bwd_row_offset_places_the_diagonal_d512():
    """The same at D = 512, where the card's kernel splits each row block's
    output columns over two warpgroups: the second half of N as a row shard
    (row_offset = B/2) against the full batch, and the shard against the
    reference's kernel in interpret mode with the same offset."""
    rng = np.random.default_rng(7)
    d = 512
    n, c = _unit_rows(rng, B, d), _unit_rows(rng, B, d)
    n_t, c_t = torch.from_numpy(n), torch.from_numpy(c)
    rl, cl = tfl.fused_lean_lse_plain(n_t, c_t, nomax=True)
    dn, dc = tfl.fused_ce_bwd(n_t, c_t, rl, cl)
    half = B // 2
    dn_lo, dc_lo = tfl.fused_ce_bwd(n_t[:half], c_t, rl[:half], cl, row_offset=0)
    dn_hi, dc_hi = tfl.fused_ce_bwd(n_t[half:], c_t, rl[half:], cl, row_offset=half)
    np.testing.assert_allclose(torch.cat([dn_lo, dn_hi]).numpy(), dn.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose((dc_lo + dc_hi).numpy(), dc.numpy(), rtol=0, atol=1e-6)
    want_dn, want_dc = jfl._fused_bwd_call(
        jnp.asarray(n[half:]), jnp.asarray(c), jnp.asarray(rl[half:].numpy()), jnp.asarray(cl.numpy()), 0.0,
        half, interpret=True,
    )
    assert _rel(dn_hi.numpy(), want_dn) < 1e-4
    assert _rel(dc_hi.numpy(), want_dc) < 1e-4


def test_bwd_row_offset_places_the_diagonal():
    """A row shard of N against the full C: dn equals the full batch's rows
    of dn, and the shard's dc is its share of the full dc."""
    rng = np.random.default_rng(4)
    n, c = _unit_rows(rng, B, D), _unit_rows(rng, B, D)
    n_t, c_t = torch.from_numpy(n), torch.from_numpy(c)
    rl, cl = tfl.fused_lean_lse_plain(n_t, c_t, nomax=True)
    dn, dc = tfl.fused_ce_bwd(n_t, c_t, rl, cl)
    half = B // 2
    dn_lo, dc_lo = tfl.fused_ce_bwd(n_t[:half], c_t, rl[:half], cl, row_offset=0)
    dn_hi, dc_hi = tfl.fused_ce_bwd(n_t[half:], c_t, rl[half:], cl, row_offset=half)
    np.testing.assert_allclose(torch.cat([dn_lo, dn_hi]).numpy(), dn.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose((dc_lo + dc_hi).numpy(), dc.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "tau,max_abs",
    [(1.0, "bound"), (0.1, "bound"), (0.1, None)],
    ids=["tau1-nomax", "tau0.1-nomax", "tau0.1-shifted"],
)
def test_fused_ce_loss_and_grads_match_jax(pair, tau, max_abs):
    n, c = pair
    max_abs_logit = (1.0 / tau) if max_abs == "bound" else None

    def jax_loss(nn_, cc):
        return jfl.fused_bidirectional_ce(nn_, cc, tau, 0.0, True, max_abs_logit)

    want_loss, (want_dn, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(n), jnp.asarray(c)
    )
    n_t = torch.from_numpy(n).requires_grad_(True)
    c_t = torch.from_numpy(c).requires_grad_(True)
    loss = tfl.fused_bidirectional_ce(n_t, c_t, tau, 0.0, max_abs_logit)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-5)
    assert n_t.grad.dtype == torch.float32
    assert _rel(n_t.grad.numpy(), want_dn) < 1e-4
    assert _rel(c_t.grad.numpy(), want_dc) < 1e-4


def test_outside_the_envelopes_is_materialized_f32():
    """B=100 fits no kernel: both sides take the f32 [B, B] path."""
    rng = np.random.default_rng(5)
    n, c = _unit_rows(rng, 100, D), _unit_rows(rng, 100, D)
    assert tfl.ce_route(100, D, 0.0) == "materialized"

    def jax_loss(nn_, cc):
        return jfl.fused_bidirectional_ce(nn_, cc, 0.5, 0.0, True, 2.0)

    want_loss, (want_dn, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(n), jnp.asarray(c)
    )
    n_t = torch.from_numpy(n).requires_grad_(True)
    c_t = torch.from_numpy(c).requires_grad_(True)
    loss = tfl.fused_bidirectional_ce(n_t, c_t, 0.5, 0.0, 2.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(want_dn), rtol=0, atol=1e-7)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(want_dc), rtol=0, atol=1e-7)


def test_label_smoothing_takes_the_stats_path_on_cpu(pair):
    n, c = pair

    def jax_loss(nn_, cc):
        return jfl.fused_bidirectional_ce(nn_, cc, 0.5, 0.1, True, 2.0)

    want_loss, (want_dn, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(n), jnp.asarray(c))
    n_t = torch.from_numpy(n).requires_grad_(True)
    c_t = torch.from_numpy(c).requires_grad_(True)
    loss = tfl.fused_bidirectional_ce(n_t, c_t, 0.5, 0.1, 2.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-5)
    assert _rel(n_t.grad.numpy(), want_dn) < 1e-4
    assert _rel(c_t.grad.numpy(), want_dc) < 1e-4


@pytest.mark.parametrize(
    "b,d,eps,route",
    [
        (8192, 128, 0.0, "kernel"),
        (256, 128, 0.1, "stats"),
        (16384, 128, 0.0, "kernel"),
        (16384, 128, 0.1, "stats"),
        (100, 128, 0.0, "materialized"),
        (256, 64, 0.0, "materialized"),
    ],
)
def test_route_on_cpu(b, d, eps, route):
    assert tfl.ce_route(b, d, eps) == route


@pytest.mark.parametrize(
    "b,d,eps,expected",
    [
        (16384, 128, 0.0, "kernel"),
        (8192, 128, 0.1, "stats"),
        (256, 256, 0.0, "kernel"),
    ],
    # stable ids: every case expected NotImplementedError before its kernels existed
    ids=["16384-128-0.0-col-blocked", "8192-128-0.1-stats kernel", "256-256-0.0-D=128"],
)
def test_route_on_cuda_raises_for_unported_kernels(b, d, eps, expected):
    """The col-blocked range, label smoothing and every D % 128 == 0 route
    to the kernels; the route depends on the shape alone, not the device."""
    assert tfl.ce_route(b, d, eps) == expected
    assert tfl.ce_route(8192, 128, 0.0) == "kernel"
    for wide in (256, 384, 512, 1024):
        assert tfl.ce_route(8192, wide, 0.1) == "stats"
        assert tfl.ce_route(16384, wide, 0.0) == "kernel"


@pytest.mark.parametrize(
    "kernel,d",
    [("lean-nomax", 256), ("lean-shifted", 256), ("bwd-eps0", 256), ("bwd-eps0.1", 256), ("stats", 256),
     ("bwd-eps0", 512), ("bwd-eps0.1", 512)],
    # the D = 256 cases keep their ids; the backward's also run at D = 512
    ids=["lean-nomax", "lean-shifted", "bwd-eps0", "bwd-eps0.1", "stats", "bwd-eps0-d512", "bwd-eps0.1-d512"],
)
def test_d256_plain_versions_match_pallas(kernel, d):
    """At D = 256, where the CUDA kernels run two 128-deep chunks (and the
    backward at D = 512 as well, where its two warpgroups split each row
    block's output columns): the plain versions the card's kernels are held
    against, against the reference's kernels in interpret mode, to the
    D = 128 tolerances."""
    rng = np.random.default_rng(6)
    b, tau = 256, 0.2
    n = _unit_rows(rng, b, d)
    # positives from near their row to nearly random, so the ranks spread
    c = _unit_rows(rng, b, d) * rng.uniform(0.5, 12.0, size=(b, 1)).astype(np.float32) + n
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    n_scaled = n / np.float32(tau)
    nt, ct = torch.from_numpy(n_scaled), torch.from_numpy(c)
    if kernel.startswith("lean"):
        nomax = kernel == "lean-nomax"
        want = jfl._fused_lean_call(
            jnp.asarray(n_scaled), jnp.asarray(c), interpret=True, max_abs_logit=(1.0 / tau) if nomax else None
        )
        for g, w in zip(tfl.fused_lean_lse(nt, ct, nomax=nomax), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-6)
    elif kernel.startswith("bwd"):
        eps = 0.1 if kernel == "bwd-eps0.1" else 0.0
        row_lse, col_lse = jfl._fused_lean_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True)
        want = jfl._fused_bwd_call(jnp.asarray(n_scaled), jnp.asarray(c), row_lse, col_lse, eps, interpret=True)
        got = tfl.fused_ce_bwd(nt, ct, torch.from_numpy(np.array(row_lse)), torch.from_numpy(np.array(col_lse)), eps)
        for g, w in zip(got, want):
            assert g.shape == (b, d) and _rel(g.numpy(), w) < 1e-4
    else:
        want_rows, want_cols = (np.asarray(x) for x in jfl._fused_stats_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True))
        got_rows, got_cols = (x.numpy() for x in tfl.fused_stats_sweep(nt, ct, tfl.same_tile_diag(nt, ct)))
        assert want_rows[:, 3].max() > 0  # ranks are not all 0
        np.testing.assert_allclose(got_rows[:, [0, 2]], want_rows[:, [0, 2]], rtol=0, atol=5e-6)  # lse, diag
        np.testing.assert_allclose(got_rows[:, 1], want_rows[:, 1], rtol=0, atol=1e-4)  # row sum
        np.testing.assert_array_equal(got_rows[:, 3], want_rows[:, 3])  # rank
        np.testing.assert_allclose(got_cols[0], want_cols[0], rtol=0, atol=5e-6)
        np.testing.assert_allclose(got_cols[1], want_cols[1], rtol=0, atol=1e-4)


def test_no_d128_shape_in_the_envelopes_raises_on_cuda():
    """Every B the reference's kernels take (B % 128 == 0 up to 8192, B %
    1024 == 0 up to 65536), with and without label smoothing."""
    sizes = list(range(128, 8193, 128)) + list(range(9216, 65537, 1024))
    for b in sizes:
        assert tfl.ce_route(b, 128, 0.0) == "kernel"
        assert tfl.ce_route(b, 128, 0.1) == "stats"
    assert tfl.ce_route(8320, 128, 0.0) == "materialized"
    assert tfl.ce_route(65536 + 1024, 128, 0.1) == "materialized"


def test_lean_lse_shifted_large_logits_matches_pallas(pair):
    """The shifted form at tau = 0.01 (|S| up to 100, where the unshifted
    sums overflow f32) against the reference's shifted kernel. Tolerance 5e-6
    plus 1e-6 of |lse|: S itself is an f32 sum of 128 products summed in
    another order, a few ulps of |S| (7.6e-6 an ulp at 100)."""
    n, c = pair
    n_scaled = n / np.float32(0.01)
    want_r, want_c = jfl._fused_lean_call(jnp.asarray(n_scaled), jnp.asarray(c), interpret=True)
    got_r, got_c = tfl.fused_lean_lse(torch.from_numpy(n_scaled), torch.from_numpy(c), nomax=False)
    for got, want in ((got_r, want_r), (got_c, want_c)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 50
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=5e-6)


def _lean_ranges(units: int, ctas: int) -> np.ndarray:
    """CTA k's units [k U / G, (k + 1) U / G), as the kernel splits them."""
    return np.arange(ctas + 1, dtype=np.int64) * units // ctas


@pytest.mark.parametrize("nomax", [True, False], ids=["nomax", "shifted"])
@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("b", [1024, 8192, 16384, 65536])
def test_lean_launch_shape(b, d, nomax):
    """The lean forward's split at every envelope shape: one CTA per SM of
    the H100 (132) once there are that many units, each CTA a nonempty range
    of units; the row partials' column blocks tile B; a column merges at
    most col_parts partials (the CTAs whose ranges meet its block), and the
    workspace holds a (sum, max) pair per partial."""
    shape = tfl.lean_lse_launch_shape(b, b, d, nomax)
    consumers = 3 if (nomax and d == 128) or (not nomax and d <= 256) else 2
    nw = 128 if nomax and d <= 256 else 64
    assert shape.sub_cols == nw and shape.row_parts * shape.sub_cols == b
    assert shape.block_cols == consumers * nw
    n_x, n_y = -(-b // shape.block_cols), b // 64
    units = n_x * n_y
    assert shape.ctas == min(tfl.LEAN_SMS, units)
    if b >= 8192:
        assert shape.ctas == 132
    starts = _lean_ranges(units, shape.ctas)
    assert (np.diff(starts) >= 1).all() and starts[-1] == units
    block_first = np.arange(n_x) * n_y
    # the CTAs whose ranges meet each block: from the one holding its first
    # unit to the one holding its last
    first = np.searchsorted(starts, block_first, side="right") - 1
    last = np.searchsorted(starts, block_first + n_y - 1, side="right") - 1
    assert shape.col_parts == int((last - first + 1).max())
    assert shape.workspace_floats == 2 * (shape.row_parts * b + shape.col_parts * b)


@pytest.mark.parametrize("nomax, mib", [(True, (4.4, 257)), (False, (8.3, 513))], ids=["nomax", "shifted"])
def test_lean_workspace_sizes_in_the_docstring(nomax, mib):
    """The sizes ``fused_lean_lse``'s docstring gives at D = 128: 4.4 and
    257 MiB unshifted, 8.3 and 513 MiB shifted, at B = 8192 and 65536."""
    got = [tfl.lean_lse_launch_shape(b, b, 128, nomax).workspace_floats * 4 / 2**20 for b in (8192, 65536)]
    assert round(got[0], 1) == mib[0] and round(got[1]) == mib[1]
    doc = " ".join(tfl.fused_lean_lse.__doc__.split())
    assert "4.4 (8.3) MiB at B = 8192, 257 (513) MiB at 65536" in doc
