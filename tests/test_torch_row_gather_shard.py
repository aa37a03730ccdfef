"""K4's zero form (``embedding_lookup_pallas_shard``: a mesh rank's masked
gather from its block of a row-sharded table) and K4's int64 ids (ROADMAP
C12), held against the JAX package on the CPU.

The zero form's plain version must equal the reference's ``_exchange``
arithmetic on one rank (``jodalrob_twotower_tpu/parallel/sharded_embedding.py
:251-257``), computed with ``jnp``: ``jnp.where(in_range, jnp.take(t_shard,
jnp.clip(local, 0, rows - 1), axis=0), 0)``. The clamp form with int64 ids
must equal ``jnp.take(..., mode="clip")``, XLA's clamping gather (the
default mode of ``jnp.take`` on the CPU wraps -1 and fills NaN past R). Both
sides run with 64-bit JAX types where the ids are int64, so that an id past
2^31 reaches the reference as it is. The tolerance is bit-equality: a
gather copies bits. The CUDA kernel runs only on the card, where
chip_smoke.py holds it bit-exact against the same plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.ops import embedding_lookup as t_el
from jodalrob_twotower_torch.parallel.sharded_embedding import masked_shard_gather

TOTAL_ROWS, BLOCK_ROWS, D = 40, 10, 8
BIG = 2**32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU gathers run fastest on one thread, and several test
    workers sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _assert_bit_equal(got: np.ndarray, want: np.ndarray) -> None:
    """NaN where the other is NaN, every other entry bit for bit (so -0.0
    is not +0.0). A NaN's payload is not compared: XLA's CPU gather of
    bfloat16 rows hands back another quiet NaN than the one it read."""
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch float32 or bfloat16 tensor as numpy of the same dtype, bit for bit."""
    return t.numpy() if t.dtype == torch.float32 else t.view(torch.int16).numpy().view(jnp.bfloat16)


def _table(dtype: str) -> torch.Tensor:
    """A [40, 8] table from seed 0 whose rows 0, 10, 30 are NaN and rows 9,
    19, 39 are -0.0: the edge rows of every block, the rows a clamped
    out-of-range id of the reference reads before it is zeroed."""
    table = np.random.default_rng(0).normal(size=(TOTAL_ROWS, D)).astype(np.float32)
    table[[0, 10, 30]] = np.nan
    table[[9, 19, 39]] = -0.0
    return torch.from_numpy(table).to(getattr(torch, dtype))


def _ids(offset: int, id_dtype: str) -> np.ndarray:
    """Ids over the table and past both its ends, with the six edge ids
    planted; as int64 also ids past 2^31 (one that an int32 cast would wrap
    into the block)."""
    rng = np.random.default_rng(offset + 1)
    edges = [offset - 1, offset, offset + BLOCK_ROWS - 1, offset + BLOCK_ROWS, -1, TOTAL_ROWS + 3]
    ids = np.concatenate([rng.integers(-5, TOTAL_ROWS + 5, size=60), edges])
    if id_dtype == "int64":
        ids = np.concatenate([ids, [BIG + 5, -BIG + 3, 2**31, offset + BIG, offset + BLOCK_ROWS - 1 - BIG]])
    return ids.astype(id_dtype)


def _reference_exchange(t_shard: np.ndarray, ids: np.ndarray, offset: int) -> np.ndarray:
    """The reference's masked gather on one rank (``_exchange``'s lines
    251-257), in jnp on the CPU."""
    with jax.enable_x64(ids.dtype == np.int64):
        rows = t_shard.shape[0]
        local_idx = jnp.asarray(ids) - offset
        in_range = (local_idx >= 0) & (local_idx < rows)
        picked = jnp.take(jnp.asarray(t_shard), jnp.clip(local_idx, 0, rows - 1), axis=0)
        return np.asarray(jnp.where(in_range[:, None], picked, 0))


@pytest.mark.parametrize("offset", [0, 10, TOTAL_ROWS - BLOCK_ROWS], ids=["first", "middle", "last"])
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_plain_bit_equal_to_reference_exchange(dtype, id_dtype, offset):
    block = _table(dtype)[offset : offset + BLOCK_ROWS]
    ids = _ids(offset, id_dtype)
    want = _reference_exchange(_np(block), ids, offset)
    before = t_el.embedding_lookup_pallas.launches
    got = t_el.embedding_lookup_pallas_shard(block, torch.from_numpy(ids), offset, total_rows=TOTAL_ROWS)
    assert t_el.embedding_lookup_pallas.launches == before  # the CPU takes the plain version
    assert got.dtype == block.dtype and tuple(got.shape) == (ids.size, D)
    _assert_bit_equal(_np(got), want)
    # every row outside the block is +0.0 bits, NaN and -0.0 edge rows included
    outside = (ids < offset) | (ids >= offset + BLOCK_ROWS)
    assert outside.any() and not _bits(_np(got))[outside].any()
    plain = t_el.embedding_lookup_pallas_shard_plain(block, torch.from_numpy(ids), offset)
    np.testing.assert_array_equal(_bits(_np(got)), _bits(_np(plain)))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_masked_shard_gather_takes_the_zero_form(use_pallas):
    """The exchange's step 2 equals the zero form's plain version on the
    CPU on both paths, for ids of any shape, and launches nothing."""
    block = _table("float32")[10:20]
    ids = torch.from_numpy(_ids(10, "int64"))
    before = t_el.embedding_lookup_pallas.launches
    got = masked_shard_gather(block, ids, 10, use_pallas=use_pallas)
    assert t_el.embedding_lookup_pallas.launches == before
    want = t_el.embedding_lookup_pallas_shard_plain(block, ids, 10)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    shaped = t_el.embedding_lookup_pallas_shard(block, ids[:66].reshape(6, 11), 10)
    assert tuple(shaped.shape) == (6, 11, D)
    np.testing.assert_array_equal(_bits(shaped.reshape(66, D).numpy()), _bits(want[:66].numpy()))


@pytest.mark.parametrize(
    "block,ids,offset,match",
    [
        (torch.zeros(10, 8), torch.zeros(3, dtype=torch.int64), -1, "offset must be >= 0"),
        (torch.zeros(10, 8), torch.zeros(3, dtype=torch.int64), 35, "run past the table"),
        (torch.zeros(10, 8), torch.zeros(3), 0, "int32 or int64"),
        (torch.zeros(10), torch.zeros(3, dtype=torch.int32), 0, r"\[R, D\]"),
        (torch.zeros(2, 10, 8), torch.zeros(3, dtype=torch.int32), 0, r"\[R, D\]"),
        (torch.zeros(10, 8, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), 0, "float32 or bfloat16"),
    ],
    ids=["negative-offset", "block-past-R", "float-ids", "1-D-block", "3-D-block", "float64-block"],
)
def test_shard_wrapper_rejects_bad_inputs(block, ids, offset, match):
    with pytest.raises(ValueError, match=match):
        t_el.embedding_lookup_pallas_shard(block, ids, offset, total_rows=TOTAL_ROWS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_int64_ids_past_2_31_clamp_like_jnp_take_clip(dtype):
    """C12: int64 ids at or above 2^31 (and below -2^31) clamp as their
    values say, as ``jnp.take(..., mode="clip")`` does with 64-bit ids: 2^32
    + 5 reads row R - 1 and -2^32 + 3 row 0, where an int32 cast would read
    rows 5 and 3."""
    table = _table(dtype)
    ids = np.array([[BIG + 5, -BIG + 3], [2**31, 2**31 - 1], [BIG + TOTAL_ROWS - 1, 7], [-1, 2**40]], np.int64)
    with jax.enable_x64(True):
        want = np.asarray(jnp.take(jnp.asarray(_np(table)), jnp.asarray(ids), axis=0, mode="clip"))
    got = _np(t_el.embedding_lookup_pallas(table, torch.from_numpy(ids)))
    _assert_bit_equal(got, want)
    np.testing.assert_array_equal(_bits(got[0]), _bits(_np(table))[[TOTAL_ROWS - 1, 0]])
