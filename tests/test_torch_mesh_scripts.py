"""The port's mesh scripts on gloo CPU ranks (``launch_script``, one torch
thread each), at small sizes, against the JAX package's same recipes on
conftest's virtual devices, with the port's initial weights carried over
(``convert.state_dict_to_flax``) where the recipe trains:

* ``multihost_smoke``: every check of the reference's script passes on 2
  processes, with the streaming leg read from a parquet file and again fed
  from memory (the same batch counts and losses); its three sharded steps
  equal the reference's ``make_sharded_train`` on a 2-device mesh of the
  same global batches (loss rtol 1e-5, tests/test_torch_mesh_train.py):
  the multi-process run is the one-process global computation.
* ``sharded_serving_bench``: each kind's recall equal to the reference
  ``ShardedIndex``'s on 2 devices, and (exact and int8) to one device's.
* ``rowsharded_store_bench``: "rows" holds half the padded rows a rank and
  trains the same losses as "replicated", bit for bit; both within rtol
  1e-5 of the reference's ``make_sharded_indexed_train`` under
  ``store_sharding="rows"``.
* ``scaling_sweep``: 1 and 2 devices, finite losses; each size's first
  loss within 1e-2 of the reference's (bf16 towers: the tolerance of
  tests/test_torch_train_step.py's bf16 case) and within 1e-3 of each
  other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import multihost_smoke as mh
from jodalrob_twotower_torch import rowsharded_store_bench as rsb
from jodalrob_twotower_torch import scaling_sweep as sweep
from jodalrob_twotower_torch import sharded_serving_bench as ssb
from jodalrob_twotower_torch.convert import state_dict_to_flax
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset as t_make_dataset
from jodalrob_twotower_torch.models import build_model as t_build_model
from jodalrob_twotower_tpu import config as jcfg
from jodalrob_twotower_tpu.data.synthetic import make_synthetic_dataset as j_make_dataset
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.parallel.sharded_train import make_sharded_indexed_train as j_make_indexed
from jodalrob_twotower_tpu.parallel.sharded_train import make_sharded_train as j_make_sharded_train
from jodalrob_twotower_tpu.schema import TwoTowerSchema as JTwoTowerSchema
from jodalrob_twotower_tpu.serving.index import ShardedIndex as JShardedIndex
from jodalrob_twotower_tpu.serving.index import recall_vs_exact as j_recall
from jodalrob_twotower_tpu.serving.index import BruteForceIndex as JBruteForceIndex
from jodalrob_twotower_tpu.train.optimizer import build_optimizer as j_build_optimizer

torch.set_num_threads(1)


def _j_config(t_cfg):
    """The JAX TrainConfig of the port's (the same fields)."""
    return jcfg.TrainConfig(
        model=jcfg.ModelConfig(**dataclasses.asdict(t_cfg.model)),
        loss=jcfg.LossConfig(**dataclasses.asdict(t_cfg.loss)),
        optimizer=jcfg.OptimizerConfig(**dataclasses.asdict(t_cfg.optimizer)),
        data=jcfg.DataConfig(**dataclasses.asdict(t_cfg.data)),
        mesh=jcfg.MeshConfig(**dataclasses.asdict(t_cfg.mesh)),
        results_csv="")


def _carried(state, t_schema, t_cfg, j_cfg):
    """``state`` with the port's seeded initial weights (every rank draws
    them alike) and a fresh optimizer state, placed as ``state``'s leaves."""
    model = t_build_model(t_schema, t_cfg).init_flax(torch.Generator().manual_seed(t_cfg.seed))
    params, stats = state_dict_to_flax(model, model.state_dict())
    place = lambda x, ref: jax.device_put(jnp.asarray(np.asarray(x)), ref.sharding)  # noqa: E731
    params = jax.tree.map(place, params, state.params)
    stats = jax.tree.map(place, stats, state.batch_stats)
    opt = jax.tree.map(place, j_build_optimizer(j_cfg.optimizer, 10).init(params), state.opt_state)
    return state.replace(params=params, batch_stats=stats, opt_state=opt)


# -- multihost_smoke -------------------------------------------------------------


@pytest.fixture(scope="module")
def multihost():
    return {source: mh.run(2, True, source) for source in ("parquet", "memory")}


def test_multihost_smoke_passes_every_check_of_the_reference(multihost):
    for source, out in multihost.items():
        assert out["ok"] is True and out["processes"] == out["mesh_size"] == 2 and out["backend"] == "gloo"
        assert out["stream_source"] == source
        assert out["table_rows_on_this_host"] * 2 == out["table_rows_global"]
        assert out["store_rows_on_this_host"] * 2 == out["store_rows_global"]
        assert out["losses"][-1] < out["losses"][0]
        assert out["fused_matches_xla"] and out["compressed_global_matches_gspmd"] and out["store_gather_exact"]
        assert not any(out["compressed_launches"].values())  # the CPU runs the plain versions
    a, b = multihost["parquet"], multihost["memory"]
    assert a["stream_batches"] == b["stream_batches"] > 0 and a["stream_loss"] == b["stream_loss"]


def test_multihost_steps_equal_the_one_process_global_steps(multihost):
    cfg = mh.smoke_config()
    t_ds = t_make_dataset(seed=0, n_notices=mh.N_ROWS, n_companies=mh.N_ROWS, n_pairs=mh.N_PAIRS)
    j_ds = j_make_dataset(seed=0, n_notices=mh.N_ROWS, n_companies=mh.N_ROWS, n_pairs=mh.N_PAIRS)
    np.testing.assert_array_equal(t_ds.pairs, j_ds.pairs)
    j_cfg = _j_config(cfg)
    mesh = j_make_mesh(jax.devices()[:2], j_cfg.mesh)
    model = j_build_model(j_ds.schema, j_cfg, mesh)
    local_b = mh.BATCH // 2
    shards = [j_ds.pairs[p::2][:mh.N_PAIRS // 2] for p in range(2)]

    def batch(step):  # the global batch: each process's rows of the step, in process order
        rows = np.concatenate([s[step * local_b:(step + 1) * local_b] for s in shards])
        return PairBatch(j_ds.notice_store.gather(rows[:, 0]), j_ds.company_store.gather(rows[:, 1]))

    state, step, shard_batch = j_make_sharded_train(model, j_cfg, mesh, batch(0), total_steps=10)
    state = _carried(state, t_ds.schema, cfg, j_cfg)
    want = []
    for s in range(3):
        state, m = step(state, shard_batch(batch(s)))
        want.append(float(m["loss"]))
    got = multihost["parquet"]["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(multihost["parquet"]["fused_loss"] - want[0]) <= 1e-5 * abs(want[0])


# -- sharded_serving_bench --------------------------------------------------------

SERVE = dict(n_corpus=3000, n_queries=64, dim=32, k=10, query_chunk=32)


def test_sharded_serving_recall_equals_the_reference_and_one_device():
    got = {row["bench"].rsplit("_mesh_", 1)[1]: row for row in ssb.run(2, True, **SERVE)}
    corpus, queries = ssb.unit_data(SERVE["n_corpus"], SERVE["n_queries"], SERVE["dim"])
    exact = JBruteForceIndex(corpus).search(queries, k=SERVE["k"])
    mesh = j_make_mesh(jax.devices()[:2])
    for name, kw in ssb.KINDS.items():
        want = JShardedIndex(corpus, mesh, query_chunk=SERVE["query_chunk"], **kw).search(queries, k=SERVE["k"])
        row = got[name]
        assert row["recall_vs_exact_at100"] == pytest.approx(j_recall(want, exact), abs=1e-12), name
        assert row["n_ranks"] == 2 and row["shard_rows"] == SERVE["n_corpus"] // 2
        if name == "int8_rescore":
            assert row["recall_vs_exact_at100"] >= row["single_device_recall"]
        else:
            assert row["recall_vs_exact_at100"] == row["single_device_recall"], name
            assert row["queries_differing_at_ties"] == 0
    assert got["exact"]["recall_vs_exact_at100"] == 1.0


# -- rowsharded_store_bench -------------------------------------------------------

STORE = dict(n_rows=2001, n_pairs=512, batch=64, n_inner=2, reps=1)


@pytest.fixture(scope="module")
def store_rows():
    return rsb.run(2, True, **STORE)


def test_rowsharded_store_holds_half_the_rows_and_trains_the_same_losses(store_rows):
    rows, replicated, compare = store_rows
    assert rows["first_losses"] == replicated["first_losses"] and compare["losses_equal"]
    assert rows["store_rows_per_rank"] == 1001 and replicated["store_rows_per_rank"] == 2001
    assert rows["store_per_rank_mb"] == pytest.approx(replicated["store_per_rank_mb"] * 1001 / 2001)
    assert replicated["store_per_rank_mb"] == pytest.approx(replicated["store_total_mb"])
    assert all(np.isfinite(rows["first_losses"] + [rows["last_loss"], replicated["last_loss"]]))


def test_rowsharded_store_losses_match_the_reference_rows_store(store_rows):
    t_cfg = rsb.bench_config("rows", STORE["batch"])
    j_cfg = _j_config(t_cfg)
    t_schema = rsb.store_schema()
    j_schema = JTwoTowerSchema.from_dict(t_schema.to_dict())
    data = rsb.store_data(STORE["n_rows"], STORE["n_pairs"])
    b, n_inner = STORE["batch"], STORE["n_inner"]
    pairs = data["pairs"]
    mesh = j_make_mesh(jax.devices()[:2], j_cfg.mesh)
    model = j_build_model(j_schema, j_cfg, mesh)
    example = PairBatch(TowerBatch(*(m[pairs[:b, 0]] for m in data["notice"])),
                        TowerBatch(*(m[pairs[:b, 1]] for m in data["company"])))
    state, _, scan_steps, _, put_idx, put_store = j_make_indexed(model, j_cfg, mesh, example, 100, n_inner=n_inner)
    state = _carried(state, t_schema, t_cfg, j_cfg)
    stack = put_idx(np.stack([pairs[i * b:(i + 1) * b] for i in range(n_inner)]))
    _, metrics = scan_steps(state, stack, put_store(data["notice"]), put_store(data["company"]))
    np.testing.assert_allclose(store_rows[0]["first_losses"], np.asarray(metrics["loss"]), rtol=1e-5)


# -- scaling_sweep ----------------------------------------------------------------

SWEEP = dict(batch=256, steps=2, n_rows=2000)


def test_scaling_sweep_runs_one_and_two_devices_as_the_reference():
    rows = sweep.run([1, 2], True, **SWEEP)
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["vs_1dev"] == 1.0
    assert all(np.isfinite([r["loss"], r["first_loss"], r["examples_per_sec"], r["step_ms"]]).all() for r in rows)
    assert rows[1]["first_loss"] == pytest.approx(rows[0]["first_loss"], rel=1e-3)
    cfg = sweep.sweep_config()
    j_cfg = _j_config(cfg)
    b = SWEEP["batch"]
    j_ds = j_make_dataset(n_notices=SWEEP["n_rows"], n_companies=SWEEP["n_rows"], n_pairs=4 * b, n_clusters=64,
                          seed=0)
    t_schema = t_make_dataset(n_notices=16, n_companies=16, n_pairs=16, n_clusters=4, seed=0).schema
    batch = PairBatch(j_ds.notice_store.gather(j_ds.pairs[:b, 0]), j_ds.company_store.gather(j_ds.pairs[:b, 1]))
    for row, n in zip(rows, (1, 2)):
        mesh = j_make_mesh(jax.devices()[:n])
        state, step, shard_batch = j_make_sharded_train(j_build_model(j_ds.schema, j_cfg, mesh), j_cfg, mesh,
                                                        batch, 100)
        state = _carried(state, t_schema, cfg, j_cfg)
        _, m = step(state, shard_batch(batch))
        assert row["first_loss"] == pytest.approx(float(m["loss"]), rel=1e-2), n
