"""The port's towers against flax in eval mode, with the same numpy inputs
and the reference's variables mapped by the converter. JAX runs the
one-hot lookup through its Pallas kernel in interpret mode
(``embedding_lookup="onehot"``); the port runs the kernel's plain version.
Tolerances: atol 1e-5 in float32 compute; 2e-2 in bfloat16 compute, where
the two frameworks round the Dense outputs and bias adds at other places."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import MeshConfig
from jodalrob_twotower_torch.config import TrainConfig as TorchTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.data.types import PairBatch as TorchPairBatch
from jodalrob_twotower_torch.data.types import TowerBatch as TorchTowerBatch
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.models.embedding import EmbeddingCollection
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TorchTwoTowerModel
from jodalrob_twotower_torch.serving.service import FrozenState
from jodalrob_twotower_torch.train.train_step import make_encode_fn
from jodalrob_twotower_tpu.data.types import PairBatch as JaxPairBatch
from jodalrob_twotower_tpu.data.types import TowerBatch as JaxTowerBatch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JaxTwoTowerModel

from torch_parity import flax_variables, model_configs, schemas, side_inputs

CASES = {
    # (compute dtype, lookup) -> atol
    ("float32", "onehot"): 1e-5,
    ("bfloat16", "onehot"): 2e-2,
    ("float32", "auto"): 1e-5,
}


@pytest.fixture(scope="module", params=list(CASES), ids=lambda c: "-".join(c))
def pair(request):
    compute_dtype, lookup = request.param
    j_schema, t_schema = schemas()
    j_cfg, t_cfg = model_configs(compute_dtype=compute_dtype, embedding_lookup=lookup)
    j_model = JaxTwoTowerModel(j_schema, j_cfg)
    variables = flax_variables(j_model, j_schema, np.random.default_rng(7))
    t_model = TorchTwoTowerModel(t_schema, t_cfg)
    state = FrozenState(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    return j_schema, j_model, variables, t_model, state, CASES[request.param]


def _both(pair, side, dense, cat):
    j_schema, j_model, variables, t_model, state, _ = pair
    method = {"notice": j_model.encode_notice, "company": j_model.encode_company}[side]
    want = j_model.apply(variables, JaxTowerBatch(dense=dense, cat_ids=cat), method=method)
    got = make_encode_fn(t_model, side)(
        state, TorchTowerBatch(torch.from_numpy(dense), torch.from_numpy(cat))
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("side", ["notice", "company"])
def test_encode_matches_flax(pair, side):
    rng = np.random.default_rng(11)
    dense, cat = side_inputs(pair[0].side(side), rng, 37)
    got, want = _both(pair, side, dense, cat)
    assert got.dtype == np.float32 and got.shape == (37, 16)
    np.testing.assert_allclose(got, want, atol=pair[-1], rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_out_of_range_ids_clamp_like_flax(pair):
    rng = np.random.default_rng(12)
    side = pair[0].notice
    dense, cat = side_inputs(side, rng, 29, out_of_range=True)
    assert (cat < 0).any() and (cat >= np.asarray(side.vocab_sizes)).any()
    got, want = _both(pair, "notice", dense, cat)
    np.testing.assert_allclose(got, want, atol=pair[-1], rtol=0)
    clipped = np.clip(cat, 0, np.asarray(side.vocab_sizes) - 1).astype(np.int32)
    np.testing.assert_array_equal(got, _both(pair, "notice", dense, clipped)[0])


def test_wrong_cat_width_raises(pair):
    _, _, _, t_model, state, _ = pair
    encode = make_encode_fn(t_model, "company")
    dense = torch.zeros(3, t_model.schema.company.dense_dim)
    with pytest.raises(ValueError, match=r"cat_ids must be \[B, 2\]"):
        encode(state, TorchTowerBatch(dense, torch.zeros(3, 3, dtype=torch.int32)))


def test_converter_names_follow_flax(pair):
    _, _, variables, t_model, _, _ = pair
    flat = {
        "/".join(str(k.key) for k in path): np.shape(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]
    }
    assert flat["params/notice_tower/proj_title/kernel"] == (12, 16)
    assert flat["params/notice_tower/embeddings/table"] == (128 + 256 + 1024, 8)
    sd = t_model.state_dict()
    assert tuple(sd["notice_tower.proj_title.weight"].shape) == (16, 12)
    assert "notice_tower.bn_0.running_var" in sd and "company_tower.head.bias" in sd


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda p, s: p["notice_tower"]["mlp_0"].pop("kernel"), "lack params/notice_tower/mlp_0/kernel"),
        (lambda p, s: s["company_tower"]["bn_0"].pop("var"), "lack batch_stats/company_tower/bn_0/var"),
        (lambda p, s: p["company_tower"]["head"].update(kernel=np.zeros((16, 32), np.float32)), "shape"),
        (lambda p, s: p["notice_tower"]["embeddings"].update(table=np.zeros((1400, 8), np.float32)), "shape"),
        (lambda p, s: p["notice_tower"].update(extra={"kernel": np.zeros(3)}), "no place"),
    ],
)
def test_converter_rejects_missing_or_misshaped(mutate, match):
    j_schema, t_schema = schemas()
    j_cfg, t_cfg = model_configs()
    variables = flax_variables(JaxTwoTowerModel(j_schema, j_cfg), j_schema, np.random.default_rng(0))
    params = jax.tree_util.tree_map(np.copy, variables["params"])
    stats = jax.tree_util.tree_map(np.copy, variables["batch_stats"])
    params = {k: {m: dict(v) for m, v in t.items()} for k, t in params.items()}
    stats = {k: {m: dict(v) for m, v in t.items()} for k, t in stats.items()}
    mutate(params, stats)
    with pytest.raises(ValueError, match=match):
        flax_to_state_dict(TorchTwoTowerModel(t_schema, t_cfg), params, stats)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(grad_mode="scatter"), "embedding_grad='scatter'"),
        (dict(vocabs=(70_000,)), "exceeds the dense one-hot envelope"),
        (dict(embed_dim=12), "embed_dim % 8 == 0"),
    ],
)
def test_forced_onehot_raises_where_it_cannot_run(kw, match):
    kw = dict(kw)
    vocabs = kw.pop("vocabs", (30, 40))
    coll = EmbeddingCollection(vocabs, kw.pop("embed_dim", 8), lookup_mode="onehot", **kw)
    with pytest.raises(ValueError, match=match), torch.no_grad():
        coll(torch.zeros(2, len(vocabs), dtype=torch.int32))


@pytest.mark.parametrize("dim,onehot", [(8, True), (24, True), (40, True), (128, True), (12, False)])
def test_auto_takes_the_dense_kernels_at_the_reference_widths(dim, onehot):
    """On the card "auto" takes the one-hot lookup at every embed width % 8
    == 0 and the dense table gradient at every width, as the reference's
    gates do (``jodalrob_twotower_tpu/models/embedding.py:204-228``); the
    gradient kernel is built for every multiple of 8 up to 128 and raises at
    another width rather than handing the step to the scatter. The CPU keeps
    the gather and its scatter at every width."""
    emb = EmbeddingCollection((50, 70), dim)
    on_card, on_cpu = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    assert emb._onehot_lookup_active(on_card) == onehot
    assert emb._dense_grad_active(on_card)
    assert not emb._onehot_lookup_active(on_cpu) and not emb._dense_grad_active(on_cpu)


def test_build_model_single_device_only():
    _, t_schema = schemas()
    cfg = TorchTrainConfig()
    model = build_model(t_schema, cfg)
    assert not model.training
    # a mesh of one rank is one device; on a larger mesh "gspmd_rows" holds
    # the rank's block of each table's rows
    one = build_model(t_schema, cfg, mesh=SimpleNamespace(size=1))
    assert one.notice_tower.mesh is None and not one.row_sharded_keys
    from jodalrob_twotower_torch.parallel.mesh import make_mesh

    two = make_mesh(["cpu"])
    two.rank, two.size, two.shape = 1, 2, {"data": 2, "model": 1}  # rank 1 of 2, seen from this process
    rows = build_model(t_schema, cfg.replace(mesh=MeshConfig(embedding_sharding="gspmd_rows")), mesh=two)
    assert rows.row_sharded_keys == {"notice_tower.embeddings.table", "company_tower.embeddings.table"}
    emb = rows.notice_tower.embeddings
    assert emb.table.shape == (emb.total_rows // 2, emb.embed_dim) and emb.row_offset == emb.total_rows // 2
    # under the compressed sync each rank's block is a batch of its own: no
    # global statistics or masks, tables replicated (row-sharded if sparse)
    per_rank = build_model(t_schema, cfg.replace(mesh=MeshConfig(grad_compression="int16")), mesh=two)
    assert per_rank.notice_tower.mesh is None and not per_rank.row_sharded_keys
    assert all(m.mesh is None for m in per_rank.modules() if hasattr(m, "running_mean"))
    sparse = build_model(t_schema, cfg.replace(mesh=MeshConfig(grad_compression="bf16"), sparse_tables=True),
                         mesh=two)
    assert sparse.company_tower.mesh is None and sparse.row_sharded_keys == rows.row_sharded_keys
    assert not any(m.use_pallas for m in model.modules() if isinstance(m, EmbeddingCollection))
    # the training form follows the module's flag and needs a generator for dropout
    model.train()
    batch = TorchTowerBatch(
        torch.randn(4, t_schema.company.dense_dim), torch.zeros(4, 2, dtype=torch.int32)
    )
    with pytest.raises(ValueError, match="torch.Generator"):
        model.encode_company(batch)
    out = model.company_tower(batch, generator=torch.Generator().manual_seed(0))
    assert out.shape == (4, cfg.model.final_embedding_dim) and torch.isfinite(out).all()


@pytest.mark.parametrize("kw", [{"grad_mode": "dense"}, {"lookup_mode": "onehot"}])
def test_a_lookup_first_called_in_inference_mode_still_trains(kw):
    """A resumed run validates before it trains: the dense-gradient and
    one-hot lookups' tile maps, cached at their first call, must not be
    inference tensors that the next step's backward cannot save."""
    emb = EmbeddingCollection((5, 7), 8, **kw)
    ids = torch.tensor([[0, 1], [4, 6], [2, 2]])
    with torch.inference_mode():
        emb(ids)
    emb(ids).float().sum().backward()
    assert emb.table.grad is not None and torch.isfinite(emb.table.grad).all()


def test_reference_shape_has_the_reference_param_count():
    """TrainConfig() on reference_shaped_schema(): 2.19M params, as flax."""
    from jodalrob_twotower_torch.schema import reference_shaped_schema

    model = build_model(reference_shaped_schema(), TorchTrainConfig())
    assert sum(p.numel() for p in model.parameters()) == 2_186_112


def test_use_pallas_lookup_model_matches_flax():
    """``MeshConfig.use_pallas_lookup`` builds towers whose gathers take the
    row-gather kernel (its plain version on the CPU); the model equals the
    reference's, run with the plain gather (its Pallas gather runs on a CPU
    only in interpret mode), to 1e-5 in float32 compute."""
    j_schema, t_schema = schemas()
    j_cfg, t_cfg = model_configs(compute_dtype="float32")
    j_model = JaxTwoTowerModel(j_schema, j_cfg)
    variables = flax_variables(j_model, j_schema, np.random.default_rng(8))
    t_model = build_model(t_schema, TorchTrainConfig(model=t_cfg, mesh=MeshConfig(use_pallas_lookup=True)))
    colls = [m for m in t_model.modules() if isinstance(m, EmbeddingCollection)]
    assert len(colls) == 2 and all(c.use_pallas for c in colls)
    state = FrozenState(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    rng = np.random.default_rng(13)
    for side in ("notice", "company"):
        dense, cat = side_inputs(j_schema.side(side), rng, 41, out_of_range=True)
        method = {"notice": j_model.encode_notice, "company": j_model.encode_company}[side]
        want = j_model.apply(variables, JaxTowerBatch(dense=dense, cat_ids=cat), method=method)
        got = make_encode_fn(t_model, side)(state, TorchTowerBatch(torch.from_numpy(dense), torch.from_numpy(cat)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("compute_dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_emb_overrides_match_flax(compute_dtype, atol):
    """``emb_overrides`` replaces each tower's categorical activations (the
    sparse-table step), as the reference's ``emb_overrides`` does: the same
    override arrays give the same towers' outputs, and the tables are not
    read."""
    j_schema, t_schema = schemas()
    j_cfg, t_cfg = model_configs(compute_dtype=compute_dtype)
    j_model = JaxTwoTowerModel(j_schema, j_cfg)
    variables = flax_variables(j_model, j_schema, np.random.default_rng(9))
    t_model = TorchTwoTowerModel(t_schema, t_cfg)
    t_model.load_state_dict(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    rng = np.random.default_rng(14)
    sides = [side_inputs(j_schema.side(s), rng, 23) for s in ("notice", "company")]
    overrides = [rng.normal(size=(23, len(j_schema.side(s).vocab_sizes) * 8)).astype(np.float32)
                 for s in ("notice", "company")]
    want = j_model.apply(
        variables, JaxPairBatch(*(JaxTowerBatch(dense=d, cat_ids=c) for d, c in sides)),
        emb_overrides=tuple(overrides),
    )
    with torch.no_grad():
        for coll in (t_model.notice_tower.embeddings, t_model.company_tower.embeddings):
            coll.table.fill_(float("nan"))  # a read of the table would show
        got = t_model(
            TorchPairBatch(*(TorchTowerBatch(torch.from_numpy(d), torch.from_numpy(c)) for d, c in sides)),
            train=False, emb_overrides=tuple(torch.from_numpy(o) for o in overrides),
        )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)
