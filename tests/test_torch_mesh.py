"""The port's mesh (``jodalrob_twotower_torch/parallel``) on the CPU: its
ranks are separate processes over gloo (``parallel/distributed.launch``),
held against the JAX package on ``make_mesh(jax.devices()[:n])`` over
conftest's virtual devices.

* The mesh's fused CE (``ops/fused_logits.sharded_fused_ce``) against the
  reference's ``make_sharded_fused_ce`` in Pallas interpret mode, at
  eps in {0, 0.1} and bound in {norm, None} on 2 ranks of a [256, 128]
  batch (128-row blocks: the kernels' route, their plain versions here),
  and on 4 ranks of a [64, 128] batch (16-row blocks: the materialized
  route): the loss within 1e-5, each rank's (dn, dc) within 1e-6 + 1e-4 of
  the largest gradient entry (tests/test_sharded_fused_ce.py:43-68).
* The sharded corpus eval: recall and MRR equal to the single-device eval's
  and to the reference's sharded eval, exactly.
* ``ShardedIndex``, exact and int8 (and int8 with a bf16 rescore): the rows
  found equal the reference ShardedIndex's except at ties, scores within
  1e-5.
* The mesh itself: the reference's axis errors and a live (1, 2) mesh's
  shape; a rank's exception and a missed deadline each fail the launch
  (the ranks are killed).

Each spawn gives its ranks one torch thread, a process-group timeout and a
join deadline (``SPAWN_S``), so a hung collective fails its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.evaluation.evaluator import corpus_retrieval_eval
from jodalrob_twotower_torch.parallel import mesh as tmesh
from jodalrob_twotower_torch.parallel.distributed import host_shard_pairs, launch, process_info
from jodalrob_twotower_tpu.evaluation.evaluator import sharded_corpus_retrieval_eval as j_sharded_eval
from jodalrob_twotower_tpu.ops.fused_logits import make_sharded_fused_ce
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.serving.index import ShardedIndex as JShardedIndex

import torch_mesh_workers as workers

SPAWN_S = 120  # join deadline of one spawn; each group's timeout is 60 s
PG_S = 60
K = 10


def spawn(fn, n, *args):
    return launch(fn, n, args=args, timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)


def _unit_rows(rng, b, d):
    x = rng.normal(size=(b, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


CE_CASES = [(0.3, eps, bound) for eps in (0.0, 0.1) for bound in ("norm", None)]


@pytest.fixture(scope="module")
def ce_runs():
    rng = np.random.default_rng(7)
    n, c = _unit_rows(rng, 256, 128), _unit_rows(rng, 256, 128)
    cases = [(tau, eps, (1.0 / tau) if bound == "norm" else None) for tau, eps, bound in CE_CASES]
    rng4 = np.random.default_rng(3)
    n4, c4 = _unit_rows(rng4, 64, 128), _unit_rows(rng4, 64, 128)
    cases4 = [(0.5, 0.1, 2.0)]
    return {2: (n, c, cases, spawn(workers.ce_cases, 2, n, c, cases)),
            4: (n4, c4, cases4, spawn(workers.ce_cases, 4, n4, c4, cases4))}


def _jax_ce(n, c, ranks, tau, eps, bound):
    mesh = JMesh(np.array(jax.devices()[:ranks]), ("data",))
    f = make_sharded_fused_ce(mesh, "data", temperature=tau, label_smoothing=eps, max_abs_logit=bound,
                              interpret=True)
    loss = float(jax.jit(f)(jnp.asarray(n), jnp.asarray(c)))
    dn, dc = jax.grad(f, argnums=(0, 1))(jnp.asarray(n), jnp.asarray(c))
    return loss, np.asarray(dn), np.asarray(dc)


@pytest.mark.parametrize("ranks,case", [(2, i) for i in range(len(CE_CASES))] + [(4, 0)])
def test_sharded_ce_matches_the_reference(ce_runs, ranks, case):
    n, c, cases, got = ce_runs[ranks]
    want_loss, want_dn, want_dc = _jax_ce(n, c, ranks, *cases[case])
    b = n.shape[0] // ranks
    for r, rank_out in enumerate(got):
        loss, dn, dc = rank_out[case]
        assert abs(loss - want_loss) < 1e-5, (r, loss, want_loss)
        for g, w in ((dn, want_dn[r * b : (r + 1) * b]), (dc, want_dc[r * b : (r + 1) * b])):
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) < 1e-6 + 1e-4 * scale, (r, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("rows,ranks", [(96, 4), (32, 4), (64, 2), (128, 3)])
def test_a_shard_takes_the_kernels_only_at_their_row_block(rows, ranks):
    """K8 and the sweep find a row block's diagonal in one 64-row tile, so a
    shard takes the kernels' route only where its rows, and so every rank's
    row offset, are multiples of 64. A 96- or 32-row shard (B = 384 or 128
    on 4 ranks), which the reference's kernels take, takes the materialized
    float32 statistics, on the CPU as on the card: at each rank's offset
    its row statistics are those of the float32 product, where the kernels'
    route gives those of the bfloat16-rounded operands."""
    from jodalrob_twotower_torch.ops import fused_logits as fl

    b, d = rows * ranks, 128
    inside = fl._shard_in_kernel_envelope(rows, b, d)
    assert inside == (rows % 64 == 0)
    rng = np.random.default_rng(5)
    n, c = torch.from_numpy(_unit_rows(rng, b, d)), torch.from_numpy(_unit_rows(rng, b, d))
    for r in range(ranks):
        off = r * rows
        assert not inside or off % 64 == 0
        n_s = n[off : off + rows] / 0.3
        row_stats, col_stats = fl.fused_stats_rows(n_s, c, off)
        ops = (n_s.bfloat16().float(), c.bfloat16().float()) if inside else (n_s, c)
        s = ops[0] @ ops[1].T
        assert torch.equal(row_stats[:, 0], torch.logsumexp(s, 1))
        assert torch.equal(row_stats[:, 2], s[torch.arange(rows), off + torch.arange(rows)])
        assert torch.equal(col_stats[0], torch.logsumexp(s, 0))


@pytest.fixture(scope="module")
def retrieval():
    rng = np.random.default_rng(11)
    queries = _unit_rows(rng, 50, 16)
    corpus = rng.normal(size=(1003, 16)).astype(np.float32)  # pads unevenly over 2 ranks
    positives = rng.integers(0, 1003, size=50)
    return queries, corpus, positives, spawn(workers.retrieval, 2, queries, corpus, positives, (5, 50), K)


def test_sharded_corpus_eval_equals_the_single_device_eval(retrieval):
    queries, corpus, positives, got = retrieval
    ref = corpus_retrieval_eval(queries, corpus, positives, ks=(5, 50))
    jref = j_sharded_eval(queries, corpus, positives, j_make_mesh(jax.devices()[:2]), ks=(5, 50))
    for rank in got:
        assert rank["corpus_size"] == 1003
        assert rank["recall"] == ref.recall == jref.recall
        assert rank["mrr"] == ref.mrr
        assert abs(rank["mrr"] - jref.mrr) < 1e-12


def _ties_only(got_s, got_i, want_s, want_i, tol=1e-5):
    """Rows found equal except where scores tie within ``tol`` at the k-th
    place; scores within ``tol``."""
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=tol)
    for q in range(got_i.shape[0]):
        if not np.array_equal(got_i[q], want_i[q]):
            differ = set(got_i[q]) ^ set(want_i[q])
            kth = want_s[q, -1]
            assert all(abs(s - kth) <= tol for s, i in zip(np.r_[got_s[q], want_s[q]], np.r_[got_i[q], want_i[q]])
                       if i in differ), q


@pytest.mark.parametrize("name", ["exact", "int8", "int8_rescore"])
def test_sharded_index_matches_the_reference(retrieval, name):
    queries, corpus, _, got = retrieval
    kw = {"kind": "exact" if name == "exact" else "int8"}
    if name == "int8_rescore":
        kw.update(rescore_depth=3 * K, rescore_dtype="bfloat16")
    want = JShardedIndex(corpus, j_make_mesh(jax.devices()[:2]), **kw).search(queries, K)
    for rank in got:
        s, i = rank[name]
        assert s.shape == i.shape == (len(queries), K) and i.dtype == np.int32
        _ties_only(s, i, np.asarray(want.scores), np.asarray(want.indices))
    assert np.array_equal(got[0][name][1], got[1][name][1]) and np.array_equal(got[0][name][0], got[1][name][0])


def test_make_mesh_keeps_the_reference_axis_errors():
    with pytest.raises(ValueError, match="not divisible by model_axis"):
        tmesh.make_mesh(["cpu"] * 3, TMeshConfig(model_axis=2))
    with pytest.raises(ValueError, match=r"mesh 3x1 != 4 devices"):
        tmesh.make_mesh(["cpu"] * 4, TMeshConfig(data_axis=3))
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        tmesh.make_mesh(["cpu"] * 2, TMeshConfig(model_axis=2))
    live = spawn(workers.mesh_shape, 2, TMeshConfig(model_axis=2))  # a (1, 2) mesh
    assert [r["shape"] for r in live] == [{"data": 1, "model": 2}] * 2
    assert [(r["rank"], r["model_index"], r["is_main"]) for r in live] == [(0, 0, True), (0, 1, False)]
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        tmesh.make_mesh(["cpu"] * 2)
    one = tmesh.make_mesh(["cpu"])  # no process group: a mesh of one
    assert (one.size, one.rank, one.shape[tmesh.DATA_AXIS], one.is_main) == (1, 0, 1, True)
    assert one.block(6) == slice(0, 6) and process_info() == (0, 1)
    pairs = np.arange(10).reshape(5, 2)
    assert host_shard_pairs(pairs) is pairs
    assert tmesh.resolve_embedding_sharding(TMeshConfig(), _schema(100)) == "replicated"
    assert tmesh.resolve_embedding_sharding(TMeshConfig(), _schema(70_000)) == "gspmd_rows"


def _schema(vocab):
    from jodalrob_twotower_torch.schema import tiny_synthetic_schema

    return tiny_synthetic_schema(n_categorical=2, vocab_size=vocab)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*planted"):
        spawn(workers.fails, 2, "planted")


def test_a_hung_rank_misses_the_deadline():
    with pytest.raises(TimeoutError, match="1 of 2 ranks not done in 5 s"):
        launch(workers.hangs, 2, timeout_s=PG_S, join_timeout_s=5, threads=1)


def test_state_shardings_name_the_row_sharded_leaves():
    """The reference's rule: the tables would be row-sharded, everything
    else replicated; the port's mesh runs every leaf replicated."""
    from jodalrob_twotower_torch.config import TrainConfig
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.sharded_train import state_shardings
    from jodalrob_twotower_torch.train.train_step import create_train_state

    model = build_model(_schema(300), TrainConfig())
    state, _ = create_train_state(model, TrainConfig(), 0, 10, device="cpu")
    one = tmesh.make_mesh(["cpu"])
    assert set(state_shardings(state, one, shard_tables=False).values()) == {"replicated"}
    rows = {k for k, v in state_shardings(state, one).items() if v == "rows"}
    assert rows == {"notice_tower.embeddings.table", "company_tower.embeddings.table"}


def test_pipeline_sharding_gives_the_rank_its_block():
    """``train_batches`` and ``prefetch_to_device`` with ``sharding=`` a mesh:
    rank 1 of 2 gets rows [B/2, B) of every global batch, on its device
    (the rank and size set on a mesh of this one process)."""
    from jodalrob_twotower_torch.data.pipeline import epoch_batches, prefetch_to_device, train_batches
    from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(_schema(40), n_notices=64, n_companies=64, n_pairs=256, n_clusters=4, seed=0)
    rank1 = tmesh.make_mesh(["cpu"])
    rank1.rank, rank1.size = 1, 2
    whole = list(train_batches(ds.notice_store, ds.company_store, ds.pairs, 32, seed=3, device="cpu",
                               background=False))
    mine = list(train_batches(ds.notice_store, ds.company_store, ds.pairs, 32, seed=3, sharding=rank1,
                              background=False))
    fed = list(prefetch_to_device(iter(whole), sharding=rank1))
    assert len(whole) == len(mine) == len(fed) == len(list(epoch_batches(ds.pairs, 32))) == 8
    for w, m, f in zip(whole, mine, fed):
        for got in (m, f):
            assert got.batch_size == 16
            for ws, gs in zip(w, got):
                assert torch.equal(gs.dense, ws.dense[16:]) and torch.equal(gs.cat_ids, ws.cat_ids[16:])
