"""The int8 index scan's product (``ops/int8_scan``): its plain version,
which the CPU runs and the card's kernel is held to in ``chip_smoke.py``,
against the JAX reference's int8 scoring, ``jnp.dot(bf16(q),
values.astype(bf16), preferred_element_type=f32) * scale``; the wrapper's
refusals; and the flat, chunked and sharded int8 indexes, which score each
chunk through the wrapper, one call a chunk, with the answers of the
expression they scored with before it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.ops import int8_scan as i8
from jodalrob_twotower_torch.parallel.mesh import Mesh
from jodalrob_twotower_torch.serving import index as t_index
from jodalrob_twotower_torch.utils.profiling import kernel_launches

U = 2.0**-24  # float32's unit roundoff


def _operands(q: int, c: int, d: int, seed: int, integer: bool = False):
    """bf16 queries [q, d] (normal, or integers in [-8, 8]), int8 rows [c, d]
    over the whole range and scales [c], the last three rows padding (zero
    values, scale 0) as the chunked index pads."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(-8, 9, size=(q, d)) if integer else rng.normal(size=(q, d))
    values = rng.integers(-127, 128, size=(c, d)).astype(np.int8)
    scales = rng.uniform(1e-3, 2e-2, size=c).astype(np.float32)
    values[-3:], scales[-3:] = 0, 0.0
    return (torch.from_numpy(queries.astype(np.float32)).to(torch.bfloat16), torch.from_numpy(values),
            torch.from_numpy(scales))


def _reference(queries: torch.Tensor, values: torch.Tensor, scales: torch.Tensor) -> np.ndarray:
    """The JAX package's int8 scoring (``Int8Index._topk_impl``)."""
    qbf = jnp.asarray(queries.float().numpy()).astype(jnp.bfloat16)
    sims = jnp.dot(qbf, jnp.asarray(values.numpy()).T.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    return np.asarray(sims * jnp.asarray(scales.numpy())[None, :])


SHAPES = [(q, d) for q in (1, 7, 256) for d in (32, 100, 128)]
RAGGED_C = 1001  # not a multiple of 4, of 64 or of a chunk


@pytest.mark.parametrize("q,d", SHAPES)
def test_plain_equals_reference_where_every_sum_is_exact(q, d):
    """Integer queries: every partial sum is an integer below 2^24, exact in
    float32 in any order, so the two agree bit for bit."""
    queries, values, scales = _operands(q, RAGGED_C, d, seed=q * 1000 + d, integer=True)
    got = i8.int8_scan_plain(queries, values, scales)
    assert got.shape == (q, RAGGED_C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _reference(queries, values, scales))
    assert not got[:, -3:].any()


@pytest.mark.parametrize("q,d", SHAPES)
def test_plain_matches_reference(q, d):
    """Normal queries: the products are exact in float32 on both sides and
    only the order of the sum differs, so the two lie within the bound of
    any two orders of a float32 sum of d terms and a scale, 2 d u of
    sum |q v| x scale."""
    queries, values, scales = _operands(q, RAGGED_C, d, seed=q * 1000 + d + 1)
    got = i8.int8_scan_plain(queries, values, scales).numpy()
    want = _reference(queries, values, scales)
    bound = 2 * d * U * (queries.float().abs() @ values.float().abs().T).numpy() * scales.numpy()[None, :]
    assert (np.abs(got - want) <= bound).all()
    assert not got[:, -3:].any()


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    queries, values, scales = _operands(5, 300, 64, seed=3)
    before = kernel_launches()["int8_scan"]
    got = i8.int8_scan(queries, values, scales)
    assert torch.equal(got, i8.int8_scan_plain(queries, values, scales))
    assert kernel_launches()["int8_scan"] == before


REFUSALS = ["queries_dtype", "values_dtype", "scales_dtype", "queries_strided", "values_strided", "scales_strided",
            "depth", "scales_length", "rank", "device"]


@pytest.mark.parametrize("bad", REFUSALS)
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    queries, values, scales = _operands(4, 64, 32, seed=4)
    if bad == "queries_dtype":
        queries = queries.float()
    elif bad == "values_dtype":
        values = values.to(torch.int16)
    elif bad == "scales_dtype":
        scales = scales.double()
    elif bad == "queries_strided":
        queries = torch.cat([queries, queries], dim=1)[:, ::2]
    elif bad == "values_strided":
        values = values.T.contiguous().T
    elif bad == "scales_strided":
        scales = torch.stack([scales, scales], dim=1)[:, 0]
    elif bad == "depth":
        queries = queries[:, :16].contiguous()
    elif bad == "scales_length":
        scales = scales[:-1]
    elif bad == "rank":
        scales = scales[:, None]
    else:
        values = values.to("meta")
    with pytest.raises(ValueError):
        i8.int8_scan(queries, values, scales)


def test_counter_is_listed_by_kernel_launches():
    assert "int8_scan" in kernel_launches() and i8.int8_scan.launches >= 0


# -- the indexes ------------------------------------------------------------------


def _scored_before(index, queries: torch.Tensor, k: int):
    """An int8 index's first pass and rescore as they were scored before the
    wrapper: the bf16 queries widened, each chunk's rows widened, a float32
    product, then the scale; rows int64."""
    qbf = queries.to(torch.bfloat16).float()
    values, scales = index.values, index.scales  # [nc, C, D], [nc, C, 1]
    nc, c, d = values.shape
    kk = max(k, min(max(k, index.rescore_depth or 0), c))
    s, i = t_index._scanned_topk(lambda qs, ci: (qs @ values[ci].float().T).mul_(scales[ci][:, 0][None, :]),
                                 nc, c, index.n_valid, qbf, kk)
    if index.rescore_depth:
        if index.rescore_rows is not None:
            s, i = t_index._rescore_topk(queries, s, i, k, index.rescore_rows)
        else:
            s, i = t_index._rescore_topk(queries, s, i, k, values.reshape(-1, d), scales.reshape(-1, 1))
    return s, i


def _before(index, queries: torch.Tensor, k: int):
    s, i = _scored_before(index, queries, k)
    return s, i.to(torch.int32)


def _sharded_before(index, queries: torch.Tensor, k: int):
    """A one-rank ``ShardedIndex``'s int8 search as it was scored before the
    wrapper: its block's rows, their global numbers, then the merge."""
    assert index.block.values.shape[:2] == (1, index.shard_rows) and index.block.n_valid == index.n_valid - index.row0
    s, i = _scored_before(index.block, queries, k)
    s2, sel = torch.topk(s, k, dim=1)
    return s2, torch.gather(i + index.row0, 1, sel).to(torch.int32)


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


INDEXES = [  # (name, kind, keyword arguments, wrapper calls a search of one query block)
    ("flat", "int8", {}, 1),
    ("chunked", "int8", {"corpus_chunk": 384}, 3),
    ("chunked_rescore_int8", "int8", {"corpus_chunk": 384, "rescore_depth": 20}, 3),
    ("chunked_rescore_bf16", "int8", {"corpus_chunk": 384, "rescore_depth": 20, "rescore_dtype": "bfloat16"}, 3),
    ("flat_rescore_bf16", "int8", {"rescore_depth": 20, "rescore_dtype": "bfloat16"}, 1),
    ("sharded", "sharded", {}, 1),
    ("sharded_rescore_bf16", "sharded", {"rescore_depth": 20, "rescore_dtype": "bfloat16"}, 1),
]


@pytest.mark.parametrize("name,kind,kw,calls", INDEXES, ids=[x[0] for x in INDEXES])
def test_int8_paths_score_each_chunk_through_the_wrapper(monkeypatch, name, kind, kw, calls):
    rng = np.random.default_rng(7)
    corpus, queries = _unit(rng, 1000, 16), torch.from_numpy(_unit(rng, 24, 16))  # 1000 = 2 x 384 + 232
    if kind == "sharded":
        mesh = Mesh("cpu")
        assert mesh.size == 1
        index = t_index.ShardedIndex(corpus, mesh, kind="int8", **kw)
        want = _sharded_before(index, queries, 10)
    else:
        index = t_index.Int8Index(corpus, device="cpu", **kw)
        want = _before(index, queries, 10)
    seen = []

    def counted(qs, values, scales):
        seen.append((tuple(qs.shape), qs.dtype, tuple(values.shape)))
        return i8.int8_scan(qs, values, scales)

    monkeypatch.setattr(t_index, "int8_scan", counted)
    got = index.topk_body(queries, 10)
    assert len(seen) == calls
    assert all(shape == (24, 16) and dtype == torch.bfloat16 for shape, dtype, _ in seen)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
