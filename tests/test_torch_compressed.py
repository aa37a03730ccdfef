"""The compressed gradient sync (``parallel/compressed_grads.py``, A12b item
4) against the JAX package, on the CPU: the port's ranks are separate
processes over gloo (``parallel/distributed.launch``, one torch thread
each, one launch of 2 ranks and one of 4 for the module), the reference
runs on ``jax.devices()[:n]`` of conftest's virtual devices with the same n,
both from the same seeded numpy inputs and flax variables (``convert.py``).
Ports tests/test_compressed_grads.py and ``__graft_entry__.py``'s modes 8,
12 and 13.

* The wire at n = 2 and 4 against ``compressed_psum_tree`` under
  ``shard_map``: int16 sums and residuals bit-equal; bf16 residuals
  bit-equal and sums within n bf16 roundings of the reference's (the sum's
  order differs: gloo's ring against XLA's); "none" residual 0 and the sum
  bit-equal at n = 2, within n f32 roundings at 4. The one-leaf form, the
  collectives' input bytes, error feedback recovering what one sync drops.
* Steps from converted weights, dropout 0, float32 towers, the materialized
  loss (the global CE is the mesh's, whatever ``use_fused_logits``, as the
  reference's manual fused CE): per-rank BatchNorm under int16 against the
  reference's compressed step (loss rtol 1e-5; params within rtol 2e-4 /
  atol 1e-6 but for NOISE_SHARE of a leaf, each at most 2 lr a step off:
  a quantum that lands on 0 in one package and +-1 in the other turns
  Adam's first steps around; the running statistics rtol 1e-5); "global"
  under "none" without BatchNorm against the reference and against the
  port's uncompressed mesh step (loss rtol 1e-5, params rtol 2e-4 / atol
  1e-6, the reference's test tolerances); the sparse form alike against
  the reference and the uncompressed sparse mesh.
* The dryrun's relations (modes 8, 12, 13): int16's and bf16's first loss
  bit-equal to "none"'s; full batches equal to indexed steps; "global" with
  BatchNorm within 2e-3 of the uncompressed mesh step; scan equal to single
  steps; the sampled draws (each rank its own B/n rows) replayed through
  single steps.
* Learning on the planted-cluster data: int16 and bf16 within 5% of
  "none" (the reference's rel=0.05), local and global negatives, sparse;
  BatchNorm and dropout per rank; the Trainer end to end, dense and sparse,
  host-fed and sampled, with the ranks' states bit-equal, and its three
  refusals with the reference's messages.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.config import ModelConfig as TModelConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.data.pipeline import epoch_batches
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel import compressed_grads as tcg
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_torch.parallel.mesh import make_mesh as t_make_mesh
from jodalrob_twotower_torch.train.optimizer import build_optimizer as t_build_optimizer
from jodalrob_twotower_torch.train.train_step import (
    RANK_DROPOUT_STREAM,
    create_train_state,
    dropout_generator,
    step_generator,
)
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import MeshConfig as JMeshConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.parallel import compressed_grads as jcg
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.train import sparse_tables as jst
from jodalrob_twotower_tpu.train.optimizer import build_optimizer as j_build_optimizer

import torch_mesh_workers as workers
from torch_parity import flax_variables, model_configs, schemas, side_inputs

SPAWN_S = 150
PG_S = 60
N_ROWS = 256
BATCH = 64
STEPS = 2
DRYRUN_BATCH = 512  # __graft_entry__.py's max(512, 64 n): 256 rows a rank for BatchNorm's statistics
LR = 1e-2
SAMPLE_SEED = 5
NOISE_SHARE = 0.07
LEARN_BATCH = 128


def spawn(n, parts):
    return launch(workers.compressed_all, n, args=(parts,), timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)


# -- configurations ----------------------------------------------------------------


def _configs(*, bn: bool, method="none", negatives="local", sparse=False):
    """(JAX, port) TrainConfigs: torch_parity's model at float32, dropout 0,
    the materialized loss, BatchNorm ``bn``."""
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", use_batch_norm=bn)
    loss = dict(temperature=0.2, use_fused_logits=False)
    opt = dict(learning_rate=LR, embedding_learning_rate=5e-2)
    mesh = dict(grad_compression=method, compressed_negatives=negatives)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**loss), optimizer=JOptimizerConfig(**opt),
                         mesh=JMeshConfig(**mesh), sparse_tables=sparse, results_csv="")
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**loss), optimizer=TOptimizerConfig(**opt),
                         mesh=TMeshConfig(**mesh), sparse_tables=sparse, results_csv="")
    return j_cfg, t_cfg


def _learn_cfg(*, method="none", negatives="local", bn=False, dropout=0.0, sparse=False, **data):
    """The reference's test config (tests/test_compressed_grads.py:72-84) on
    the port's planted-cluster data."""
    return TTrainConfig(
        model=TModelConfig(categorical_embedding_dim=8, dense_projection_dim=16, tower_hidden_dims=(32, 16),
                           final_embedding_dim=8, dropout_rate=dropout, use_batch_norm=bn, compute_dtype="float32"),
        loss=TLossConfig(temperature=0.2, use_fused_logits=False),
        optimizer=TOptimizerConfig(learning_rate=3e-3, num_epochs=2),
        data=TDataConfig(batch_size=LEARN_BATCH, **data),
        mesh=TMeshConfig(grad_compression=method, compressed_negatives=negatives),
        sparse_tables=sparse, results_csv="")


# the parity jobs: (config kwargs, kind, method[, batches: "parity" by default])
PARITY_JOBS = {
    "int16_bn": (dict(bn=True, method="int16"), "single", "int16"),
    "full_int16_bn": (dict(bn=True, method="int16"), "full", "int16"),
    "none_bn": (dict(bn=True), "single", "none"),
    "bf16_bn": (dict(bn=True, method="bf16"), "single", "bf16"),
    "scan_int16_bn": (dict(bn=True, method="int16"), "scan", "int16"),
    "sampled_int16_bn": (dict(bn=True, method="int16"), "sampled", "int16"),
    "global_none": (dict(bn=False, negatives="global"), "single", "none"),
    "mesh_nobn": (dict(bn=False), "mesh", None),
    "global_none_bn": (dict(bn=True, negatives="global"), "single", "none", "dryrun"),
    "global_int16_bn": (dict(bn=True, method="int16", negatives="global"), "single", "int16", "dryrun"),
    "mesh_bn": (dict(bn=True), "mesh", None, "dryrun"),
    "sparse_global_none": (dict(bn=False, negatives="global", sparse=True), "single", "none"),
    "mesh_sparse": (dict(bn=False, sparse=True), "mesh_sparse", None),
    "sparse_int16": (dict(bn=False, method="int16", sparse=True), "single", "int16"),
    "sparse_scan_int16": (dict(bn=False, method="int16", sparse=True), "scan", "int16"),
    "sparse_sampled_int16": (dict(bn=False, method="int16", sparse=True), "sampled", "int16"),
}


def _parity_inputs():
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(16)
    j_cfg, _ = _configs(bn=True)
    variables = flax_variables(JTwoTowerModel(j_schema, j_cfg.model), j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    idx = {"parity": rng.integers(0, N_ROWS, size=(STEPS, BATCH, 2)).astype(np.int64),
           "dryrun": rng.integers(0, N_ROWS, size=(1, DRYRUN_BATCH, 2)).astype(np.int64)}
    pairs = rng.integers(0, N_ROWS, size=(512, 2)).astype(np.int64)
    starts = {}
    for bn in (True, False):
        t_model = TTwoTowerModel(t_schema, _configs(bn=bn)[1].model)
        stats = variables["batch_stats"] if bn else None
        params = variables["params"] if bn else _without_bn(variables["params"])
        starts[bn] = {k: v.numpy() for k, v in flax_to_state_dict(t_model, params, stats).items()}
    return j_schema, t_schema, variables, stores, idx, pairs, starts


def _without_bn(params):
    return {tower: {k: v for k, v in layers.items() if not k.startswith("bn_")} for tower, layers in params.items()}


def _learn_inputs():
    ds = make_synthetic_dataset(n_notices=2000, n_companies=2000, n_pairs=6000, n_clusters=16, seed=0)
    tr, va = ds.split(0.2, seed=0)
    model = TTwoTowerModel(ds.schema, _learn_cfg().model).init_flax(torch.Generator().manual_seed(0))
    start = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    stores = {side: (fs.dense, fs.cat_ids) for side, fs in (("notice", ds.notice_store), ("company", ds.company_store))}
    batches = {f"epoch{seed}": np.stack(list(epoch_batches(tr, LEARN_BATCH, shuffle=True, seed=seed))[:20])
               for seed in (1, 2)}
    return ds, tr, va, start, stores, batches


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _as_flax(t_schema, t_cfg, sd):
    model = TTwoTowerModel(t_schema, t_cfg.model)
    params, stats = state_dict_to_flax(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    return _leaves(params), _leaves(stats)


# -- the reference's side ----------------------------------------------------------


def _jax_compressed(j_schema, j_cfg, variables, stores, idx, method):
    """The reference's compressed single steps (dense or sparse by the
    config) from ``variables`` on a 2-device mesh: (losses, params leaves,
    batch_stats leaves)."""
    mesh = j_make_mesh(jax.devices()[:2])
    model = JTwoTowerModel(j_schema, j_cfg.model)

    def batch(i):
        return PairBatch(TowerBatch(*(x[i[:, 0]] for x in stores["notice"])),
                         TowerBatch(*(x[i[:, 1]] for x in stores["company"])))

    sparse = j_cfg.sparse_tables
    make = jcg.make_dp_compressed_sparse_train if sparse else jcg.make_dp_compressed_indexed_train
    cdp = make(model, j_cfg, mesh, batch(idx[0]), 10, method=method)
    place = lambda x, ref: jax.device_put(jnp.asarray(x), ref.sharding)  # noqa: E731
    state = cdp.state
    params = variables["params"] if j_cfg.model.use_batch_norm else _without_bn(variables["params"])
    if sparse:
        dense, tables = jst._split_embeddings(params)
        dense = jax.tree.map(place, dense, state.dense_params)
        state = state.replace(
            dense_params=dense,
            opt_state=jax.tree.map(place, j_build_optimizer(j_cfg.optimizer, 10).init(dense), state.opt_state),
            notice_table=jst.SparseTable(place(tables["notice_tower"], state.notice_table.table),
                                         state.notice_table.accumulator),
            company_table=jst.SparseTable(place(tables["company_tower"], state.company_table.table),
                                          state.company_table.accumulator))
    else:
        p = jax.tree.map(place, params, state.params)
        stats = variables["batch_stats"] if j_cfg.model.use_batch_norm else state.batch_stats
        state = state.replace(
            params=p, batch_stats=jax.tree.map(place, stats, state.batch_stats),
            opt_state=jax.tree.map(place, j_build_optimizer(j_cfg.optimizer, 10).init(p), state.opt_state))
    ns, cs = (cdp.put_store(tuple(np.asarray(x) for x in stores[s])) for s in ("notice", "company"))
    err, losses = cdp.err_state, []
    for i in idx:
        state, err, m = cdp.single_step(state, err, cdp.put_idx(i.astype(np.int32)), ns, cs)
        losses.append(float(m["loss"]))
    params = jst.merged_params(state) if sparse else state.params
    return losses, _leaves(jax.device_get(params)), _leaves(jax.device_get(state.batch_stats))


def _jax_wire(leaves, errs, method, n):
    """The reference's ``compressed_psum_tree`` over n devices: (sums,
    residuals [n, ...])."""
    mesh = JMesh(np.array(jax.devices()[:n]), ("data",))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P(), P("data")),
                       check_vma=False)
    def run(g, e):
        total, new_e = jcg.compressed_psum_tree(jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e),
                                                "data", method)
        return total, jax.tree.map(lambda x: x[None], new_e)

    total, new_e = run(jax.tree.map(jnp.asarray, leaves), jax.tree.map(jnp.asarray, errs))
    return jax.tree.map(np.asarray, total), jax.tree.map(np.asarray, new_e)


# -- the module's runs ---------------------------------------------------------------


def _wire_inputs(n: int):
    rng = np.random.default_rng(40 + n)
    leaves = {"a": rng.normal(size=(n, 7, 5)).astype(np.float32),
              "b": (1e-3 * rng.normal(size=(n, 33))).astype(np.float32),
              "c": rng.normal(size=(n, 3, 4, 2)).astype(np.float32)}
    leaves["c"][:, 0, 0, 0] = 40.0  # one large entry sets the leaf's scale
    errs = {k: (1e-3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in leaves.items()}
    return leaves, errs


FEEDBACK_STEPS = 200


def _feedback_grads(n: int) -> np.ndarray:
    # one large component sets the scale (1/127); the small ones sit below
    # half a quantum and round to 0 on every step without feedback
    g = np.full((n, 64), 1e-4, np.float32)
    g[:, 0] = 1.0
    return g


@pytest.fixture(scope="module")
def runs():
    j_schema, t_schema, variables, stores, idx, pairs, starts = _parity_inputs()
    jobs = {}
    for name, (kw, kind, method, *batches) in PARITY_JOBS.items():
        jobs[name] = {"cfg": _configs(**kw)[1], "kind": kind, "method": method, "batches": (batches or ["parity"])[0],
                      "sparse": kw.get("sparse", False), "bn": kw["bn"]}
    ds, tr, va, l_start, l_stores, l_batches = _learn_inputs()
    learn = {f"full_{m}": {"cfg": _learn_cfg(method=m), "kind": "full", "method": m, "batches": "epoch1"}
             for m in ("int16", "bf16", "none")}
    learn.update({f"global_{m}": {"cfg": _learn_cfg(method=m, negatives="global"), "kind": "single", "method": m,
                                  "batches": "epoch1"} for m in ("int16", "none")})
    learn["sparse_int16"] = {"cfg": _learn_cfg(method="int16", sparse=True), "kind": "single", "method": "int16",
                             "batches": "epoch2", "sparse": True}
    learn["bn_dropout_int16"] = {"cfg": _learn_cfg(method="int16", bn=True, dropout=0.2), "kind": "full",
                                 "method": "int16", "batches": "epoch2"}
    l_start_bn = {k: v for k, v in TTwoTowerModel(ds.schema, _learn_cfg(bn=True).model).init_flax(
        torch.Generator().manual_seed(0)).state_dict().items()}
    trainer_cfgs = {"dense": _learn_cfg(method="int16"), "dense_sampled": _learn_cfg(method="int16",
                                                                                    sample_on_device=True),
                    "sparse": _learn_cfg(method="int16", sparse=True),
                    "sparse_sampled": _learn_cfg(method="int16", sparse=True, sample_on_device=True),
                    "global_bf16": _learn_cfg(method="bf16", negatives="global")}
    base = _learn_cfg(method="int16")
    refused = {"defer": base.replace(sparse_tables=True, sparse_defer_updates=True),
               "rows": base.replace(mesh=dataclasses.replace(base.mesh, store_sharding="rows")),
               "onehot": base.replace(model=dataclasses.replace(base.model, embedding_lookup="onehot"))}
    ds_arrays = {side: (fs.dense, fs.cat_ids, fs.keys) for side, fs in (("notice", ds.notice_store),
                                                                        ("company", ds.company_store))}
    by_bn = {bn: {k: v for k, v in jobs.items() if v["bn"] == bn} for bn in (True, False)}
    parts2 = {
        "parity_bn": ("compressed_runs", (t_schema, by_bn[True], starts[True], stores, idx, pairs,
                                          SAMPLE_SEED)),
        "parity": ("compressed_runs", (t_schema, by_bn[False], starts[False], stores, idx, pairs,
                                       SAMPLE_SEED)),
        "learn": ("compressed_runs", (ds.schema, {k: v for k, v in learn.items() if k != "bn_dropout_int16"},
                                      l_start, l_stores, l_batches, tr, SAMPLE_SEED)),
        "learn_bn": ("compressed_runs", (ds.schema, {"bn_dropout_int16": learn["bn_dropout_int16"]},
                                         {k: v.numpy() for k, v in l_start_bn.items()}, l_stores, l_batches, tr,
                                         SAMPLE_SEED)),
        "trainer": ("compressed_trainer", (ds.schema, trainer_cfgs, ds_arrays, tr, va[:256], refused)),
    }
    wire_in = {n: _wire_inputs(n) for n in (2, 4)}
    methods = ("none", "int16", "bf16")
    parts2["wire"] = ("compressed_wire", (*wire_in[2], methods))
    got2 = spawn(2, parts2)
    got4 = spawn(4, {"wire": ("compressed_wire", (*wire_in[4], methods, (_feedback_grads(4), FEEDBACK_STEPS)))})
    ref = {}
    for name in ("int16_bn", "global_none", "global_none_bn", "sparse_global_none", "sparse_int16"):
        kw, _, method, *batches = PARITY_JOBS[name]
        ref[name] = _jax_compressed(j_schema, _configs(**kw)[0], variables, stores, idx[(batches or ["parity"])[0]],
                                    method)
    wire_ref = {n: {m: _jax_wire(*wire_in[n], m, n) for m in methods} for n in (2, 4)}
    return SimpleNamespace(got2=got2, got4=got4, ref=ref, wire_in=wire_in, wire_ref=wire_ref, t_schema=t_schema)


def _parity(runs, name):
    bn = PARITY_JOBS[name][0]["bn"]  # the two weight sets run apart
    return [rank["parity_bn" if bn else "parity"][name] for rank in runs.got2]


# -- the wire ------------------------------------------------------------------------


def _wire(runs, n):
    return runs.got2 if n == 2 else runs.got4


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["none", "int16", "bf16"])
def test_wire_against_the_reference(runs, n, method):
    leaves, errs = runs.wire_in[n]
    want_sum, want_err = runs.wire_ref[n][method]
    for r, rank in enumerate(_wire(runs, n)):
        got = rank["wire"][method]
        for k in leaves:
            # the residual is each rank's own arithmetic: bit-equal in every format
            np.testing.assert_array_equal(got["err"][k], want_err[k][r], err_msg=f"{method} residual {k}")
            if method == "int16" or (method == "none" and n == 2):
                np.testing.assert_array_equal(got["synced"][k], want_sum[k], err_msg=f"{method} sum {k}")
            else:
                # another summation order: within n roundings of the wire's dtype
                ulp = 2.0 ** -8 if method == "bf16" else 2.0 ** -24
                sent = leaves[k] + errs[k]
                bound = n * ulp * np.abs(sent).sum(0) + 1e-30
                assert np.all(np.abs(got["synced"][k] - want_sum[k]) <= bound), (method, n, k)
        if method == "none":
            assert all(np.all(v == 0) for v in got["err"].values())
        leaf_sum, leaf_err = got["leaf"]
        np.testing.assert_array_equal(leaf_err, got["err"]["a"])
        if method == "int16" or n == 2:  # gloo's order follows the buffer's length past two ranks
            np.testing.assert_array_equal(leaf_sum, got["synced"]["a"])
    # every rank holds the same sum
    ranks = _wire(runs, n)
    for k in leaves:
        assert all(np.array_equal(r["wire"][method]["synced"][k], ranks[0]["wire"][method]["synced"][k]) for r in ranks)


@pytest.mark.parametrize("n", [2, 4])
def test_wire_bytes_from_the_buffers(runs, n):
    leaves, _ = runs.wire_in[n]
    elems = sum(v[0].size for v in leaves.values())
    got = _wire(runs, n)[0]["wire"]
    assert got["none"]["buffers"] == [("all_reduce", 4 * elems)]
    assert got["bf16"]["buffers"] == [("all_reduce", 2 * elems)]
    assert got["int16"]["buffers"] == [("all_reduce", 4 * len(leaves)), ("all_gather", elems)]
    assert tcg.ring_wire_bytes(got["none"]["buffers"], n) == int(2 * (n - 1) * 4 * elems / n)
    assert tcg.ring_wire_bytes(got["int16"]["buffers"], n) == int(2 * (n - 1) * 4 * len(leaves) / n) + (n - 1) * elems


@pytest.mark.parametrize("method", ["none", "int16", "bf16"])
def test_compressed_psum_close_to_exact(runs, method):
    """tests/test_compressed_grads.py:47-63 at n = 4."""
    leaves, errs = runs.wire_in[4]
    for k, g in leaves.items():
        sent = g + errs[k]
        exact = sent.sum(0)
        tol = {"none": 1e-5 * np.abs(sent).sum(0).max(), "int16": 4 * np.abs(sent).max() / 127 / 2 + 1e-6,
               "bf16": 0.05 * max(1.0, np.abs(sent).max())}[method]
        for rank in runs.got4:
            got = rank["wire"][method]
            np.testing.assert_allclose(got["synced"][k], exact, atol=tol)
        if method == "int16":
            # the residuals hold exactly what the wire dropped
            resid = sum(rank["wire"][method]["err"][k] for rank in runs.got4)
            np.testing.assert_allclose(resid + runs.got4[0]["wire"][method]["synced"][k], exact, atol=1e-5)


def test_int16_error_feedback_is_unbiased(runs):
    """tests/test_compressed_grads.py:66-94 at n = 4: the small components
    are recovered with feedback and lost without it."""
    g = _feedback_grads(4)
    acc, lost = runs.got4[0]["wire"]["feedback"]
    exact_total = FEEDBACK_STEPS * g.sum(axis=0)
    np.testing.assert_allclose(acc[1:], exact_total[1:], rtol=0.02, atol=4 * (1.0 / 127))
    np.testing.assert_allclose(acc[0], exact_total[0], rtol=1e-3)
    assert abs(lost[1]) < 1e-6


def test_int16_wire_residual_within_half_a_quantum(runs):
    leaves, errs = runs.wire_in[2]
    for r, rank in enumerate(runs.got2):
        for k, g in leaves.items():
            scale = max(np.abs(g + errs[k]).max(axis=tuple(range(1, g.ndim))).max(), 1e-30) / np.float32(127)
            assert np.abs(rank["wire"]["int16"]["err"][k]).max() <= scale / 2 * (1 + 1e-6), k


def test_check_method_refusals():
    cfg = _learn_cfg()
    model = TTwoTowerModel(make_synthetic_dataset(n_notices=64, n_companies=64, n_pairs=64).schema, cfg.model)
    with pytest.raises(ValueError, match="method"):
        tcg.make_dp_compressed_train_step(model, cfg, t_build_optimizer(cfg.optimizer, 10), t_make_mesh(["cpu"]),
                                          64, 10, method="int4")
    fake = SimpleNamespace(shape={"data": 512}, size=512)
    with pytest.raises(ValueError, match="256 workers"):
        tcg.make_dp_compressed_train_step(model, cfg, t_build_optimizer(cfg.optimizer, 10), fake, 512, 10,
                                          method="int16")
    tcg._check_method("int16", 256)
    tcg._check_method("bf16", 512)
    with pytest.raises(ValueError, match="must divide batch_size"):
        tcg.make_dp_compressed_indexed_train(model, cfg, SimpleNamespace(shape={"data": 3}, size=3), 64, 10,
                                             method="bf16")


# -- steps against the reference -----------------------------------------------------


def _close_state(runs, got_sd, want, bn, noise_share=0.0, steps=STEPS):
    t_cfg = _configs(bn=bn)[1]
    params, stats = _as_flax(runs.t_schema, t_cfg, got_sd)
    _, want_params, want_stats = want
    assert set(params) == set(want_params)
    for k, w in want_params.items():
        bad = ~np.isclose(params[k], w, rtol=2e-4, atol=1e-6)
        assert bad.mean() <= noise_share, (k, bad.mean(), float(np.abs(params[k] - w).max()))
        assert np.abs(params[k] - w).max() <= 2 * LR * steps + 1e-6, k
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_int16_with_per_rank_batchnorm_matches_the_reference(runs):
    """The rank's own BatchNorm statistics, averaged after the step, and the
    int16 wire: losses and states against the reference's compressed step."""
    for rank in _parity(runs, "int16_bn"):
        np.testing.assert_allclose(rank["losses"], runs.ref["int16_bn"][0], rtol=1e-5)
        _close_state(runs, rank["state"], runs.ref["int16_bn"], True, NOISE_SHARE)
        assert {"loss", "accuracy", "mrr", "similarity_gap", "z_gap"} <= set(rank["keys"])


def test_global_none_matches_the_reference_and_the_uncompressed_mesh(runs):
    """tests/test_compressed_grads.py:391-441: "global" under "none" without
    BatchNorm is the uncompressed mesh step."""
    got, mesh = _parity(runs, "global_none"), _parity(runs, "mesh_nobn")
    for rank, m in zip(got, mesh):
        np.testing.assert_allclose(rank["losses"], runs.ref["global_none"][0], rtol=1e-5)
        np.testing.assert_allclose(rank["losses"], m["losses"], rtol=1e-5)
        _close_state(runs, rank["state"], runs.ref["global_none"], False)
        for k, v in m["state"].items():
            np.testing.assert_allclose(rank["state"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
        assert all(np.all(e == 0) for e in rank["err"].values())


def test_sparse_global_none_matches_the_reference_and_the_sparse_mesh(runs):
    """tests/test_compressed_grads.py:474-530: the table exchange stays
    exact, so the sparse form under "none" with global negatives is the
    uncompressed sparse mesh step."""
    for rank, m in zip(_parity(runs, "sparse_global_none"), _parity(runs, "mesh_sparse")):
        np.testing.assert_allclose(rank["losses"], runs.ref["sparse_global_none"][0], rtol=1e-5)
        np.testing.assert_allclose(rank["losses"], m["losses"], rtol=1e-5)
        _close_state(runs, rank["state"], runs.ref["sparse_global_none"], False)
        for k, v in m["state"].items():
            np.testing.assert_allclose(rank["state"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
        assert set(rank["err"]) == {k for k in rank["state"] if "embeddings" not in k}


def test_sparse_int16_matches_the_reference(runs):
    for rank in _parity(runs, "sparse_int16"):
        np.testing.assert_allclose(rank["losses"], runs.ref["sparse_int16"][0], rtol=1e-5)
        _close_state(runs, rank["state"], runs.ref["sparse_int16"], False, NOISE_SHARE)


# -- the dryrun's relations (modes 8, 12, 13) ---------------------------------------


def test_mode8_first_loss_bit_equal_and_full_equals_indexed(runs):
    """__graft_entry__.py:285-322: the loss precedes the sync, so int16's
    and bf16's first loss is "none"'s bit for bit; the full-batch step
    equals the indexed one."""
    for int16, none, bf16, full in zip(*(_parity(runs, k) for k in ("int16_bn", "none_bn", "bf16_bn",
                                                                     "full_int16_bn"))):
        assert int16["losses"][0] == none["losses"][0] == bf16["losses"][0]
        np.testing.assert_allclose(full["losses"], int16["losses"], rtol=1e-5)
        assert full["keys"] == ["loss"]


def test_mode12_global_negatives_with_batchnorm(runs):
    """__graft_entry__.py:422-456: "global" with per-rank BatchNorm within
    2e-3 of the uncompressed mesh step (global statistics) and equal to the
    reference's; int16's first loss bit-equal to "none"'s."""
    for g, g16, mesh in zip(*(_parity(runs, k) for k in ("global_none_bn", "global_int16_bn", "mesh_bn"))):
        assert abs(g["losses"][0] - mesh["losses"][0]) <= 2e-3 * max(1.0, abs(mesh["losses"][0]))
        np.testing.assert_allclose(g["losses"], runs.ref["global_none_bn"][0], rtol=1e-5)
        assert g16["losses"][0] == g["losses"][0]


def test_mode13_sparse_against_the_uncompressed_sparse(runs):
    """__graft_entry__.py:458-486."""
    for sp, mesh, sp16 in zip(*(_parity(runs, k) for k in ("sparse_global_none", "mesh_sparse", "sparse_int16"))):
        assert abs(sp["losses"][0] - mesh["losses"][0]) <= 2e-3 * max(1.0, abs(mesh["losses"][0]))
        assert np.all(np.isfinite(sp16["losses"]))


def test_dp_compressed_scan_matches_singles(runs):
    for scan, single in zip(_parity(runs, "scan_int16_bn"), _parity(runs, "int16_bn")):
        assert scan["losses"] == single["losses"]
        for k, v in single["state"].items():
            np.testing.assert_array_equal(scan["state"][k], v, err_msg=k)


def test_dp_compressed_sampled_steps(runs):
    """Each rank draws its own B/n rows from (seed, step, rank); the draws
    replayed through single steps give the same losses and state."""
    got = _parity(runs, "sampled_int16_bn")
    for rank in got:
        assert len(rank["losses"]) == STEPS and rank["step"] == STEPS and np.all(np.isfinite(rank["losses"]))
        assert rank["losses"] == rank["replay"]
        for k, v in rank["replay_state"].items():
            np.testing.assert_array_equal(rank["state"][k], v, err_msg=k)
        assert rank["rows"].shape == (STEPS, BATCH // 2, 2)
    assert not np.array_equal(got[0]["rows"], got[1]["rows"])
    assert got[0]["losses"] == got[1]["losses"]


def test_sparse_scan_and_sampled_forms_advance(runs):
    for scan, sampled in zip(_parity(runs, "sparse_scan_int16"), _parity(runs, "sparse_sampled_int16")):
        assert len(scan["losses"]) == len(sampled["losses"]) == STEPS
        assert scan["step"] == sampled["step"] == STEPS
        assert np.all(np.isfinite(scan["losses"] + sampled["losses"]))


def test_the_ranks_states_stay_bit_equal(runs):
    for name in PARITY_JOBS:
        a, b = _parity(runs, name)
        assert a["losses"] == b["losses"], name
        for k, v in a["state"].items():
            np.testing.assert_array_equal(b["state"][k], v, err_msg=f"{name} {k}")


# -- learning ------------------------------------------------------------------------


def _learn(runs, name, part="learn"):
    return [rank[part][name] for rank in runs.got2]


@pytest.mark.parametrize("method", ["int16", "bf16"])
def test_dp_compressed_training_learns(runs, method):
    """tests/test_compressed_grads.py:97-139: within 5% of "none"."""
    got, none = _learn(runs, f"full_{method}")[0], _learn(runs, "full_none")[0]
    assert got["losses"][-1] < got["losses"][0]
    assert got["losses"][-1] == pytest.approx(none["losses"][-1], rel=0.05)
    assert got["losses"][0] == none["losses"][0]


def test_compressed_global_negatives_int16_learns(runs):
    got, none = _learn(runs, "global_int16")[0], _learn(runs, "global_none")[0]
    assert got["losses"][-1] < got["losses"][0]
    assert got["losses"][-1] == pytest.approx(none["losses"][-1], rel=0.05)


def test_compressed_sparse_int16_learns(runs):
    got = _learn(runs, "sparse_int16")[0]
    assert got["losses"][-1] < got["losses"][0] and np.all(np.isfinite(got["losses"]))


def test_dp_compressed_with_batchnorm_and_dropout(runs):
    """tests/test_compressed_grads.py:308-345: learns; the running
    statistics, averaged over the ranks, equal on both and finite."""
    a, b = _learn(runs, "bn_dropout_int16", "learn_bn")
    assert a["losses"][-1] < a["losses"][0] and np.all(np.isfinite(a["losses"]))
    stats = [k for k in a["state"] if "running_" in k]
    assert stats
    for k in stats:
        assert np.all(np.isfinite(a["state"][k]))
        np.testing.assert_array_equal(a["state"][k], b["state"][k])


def test_dropout_draws_each_ranks_own_mask():
    """Per-rank masks (reference compressed_grads.py:213-220): the towers of
    a compressed model take no global statistics or masks, and each rank's
    generator is its own stream of (seed, step, rank)."""
    ds = make_synthetic_dataset(n_notices=64, n_companies=64, n_pairs=64)
    cfg = _learn_cfg(method="int16", bn=True, dropout=0.5)
    two = t_make_mesh(["cpu"])
    two.size, two.shape = 2, {"data": 2, "model": 1}
    model = build_model(ds.schema, cfg, mesh=two).init_flax(torch.Generator().manual_seed(0))
    assert model.notice_tower.mesh is None and not model.row_sharded_keys
    assert all(m.mesh is None for m in model.modules() if hasattr(m, "running_mean"))
    state, _ = create_train_state(model, cfg, 3, 10, device="cpu")
    state.step = 7
    batch = TowerBatch(torch.from_numpy(ds.notice_store.dense[:16]), torch.from_numpy(ds.notice_store.cat_ids[:16]))
    outs = []
    for rank in (0, 1):
        two.rank = rank
        gen = dropout_generator(cfg, state, SimpleNamespace(mesh=two))
        want = step_generator(torch.device("cpu"), 3, 7, RANK_DROPOUT_STREAM, rank)
        assert torch.equal(torch.rand(8, generator=gen), torch.rand(8, generator=want))
        outs.append(model.notice_tower(batch, train=True,
                                       generator=dropout_generator(cfg, state, SimpleNamespace(mesh=two))))
    assert not torch.equal(outs[0], outs[1])


# -- the Trainer ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "dense_sampled", "sparse", "sparse_sampled", "global_bf16"])
def test_trainer_grad_compression_e2e(runs, name):
    """tests/test_compressed_grads.py:223-271 and 533-560: the Trainer
    trains, learns and validates under compression, dense and sparse,
    host-fed and sampled; the ranks' states bit-equal."""
    a, b = (rank["trainer"][name] for rank in runs.got2)
    assert a["history"][-1]["train_loss"] < a["history"][0]["train_loss"]
    assert np.isfinite(a["final_val"]["loss"])
    assert a["ranks_equal"] and b["ranks_equal"]
    clocks = ("examples_per_sec",)  # each rank's own clock
    assert [{k: v for k, v in h.items() if k not in clocks} for h in a["history"]] == \
        [{k: v for k, v in h.items() if k not in clocks} for h in b["history"]]
    assert a["step"] == b["step"] > 0


@pytest.mark.parametrize("name,match", [("defer", "defer"), ("rows", "replicated"), ("onehot", "onehot")])
def test_trainer_refusals(runs, name, match):
    for rank in runs.got2:
        assert rank["trainer"][name] is not None and match in rank["trainer"][name]


def test_grad_compression_config_validation():
    assert TMeshConfig().grad_compression == "none"
    TMeshConfig(grad_compression="bf16")
    with pytest.raises(ValueError, match="grad_compression"):
        TMeshConfig(grad_compression="fp8")


def test_compressed_negatives_config_validation():
    assert TMeshConfig().compressed_negatives == "local"
    TMeshConfig(compressed_negatives="global")
    with pytest.raises(ValueError, match="compressed_negatives"):
        TMeshConfig(compressed_negatives="batch")


def test_compressed_global_rejects_cosine():
    cfg = _learn_cfg(negatives="global")
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, loss_type="cosine_embedding"))
    with pytest.raises(ValueError, match="cosine"):
        tcg.resolve_compressed_loss(cfg, None)
    assert tcg.resolve_compressed_loss(_learn_cfg(), None) == (None, None)
