"""The kanana2 text encoder (``models/text_encoder.py``) and its expert
dispatch (``ops/moe.py``) on the CPU at small widths (hidden 64, 4 heads,
latent 16, rope 8, 8 experts top-2 with 1 shared, 1 dense + 2 MoE layers,
vocabulary 512), in float32: against the benchmark's plain reference
(``benchmark/reference/kanana.py``) on its seeded weights, the correction
bias's part in the routing, batch invariance, the dispatch's plain versions
against a loop over pairs, and ``search_device`` through a notice tower that
encodes its title."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import gen_kanana
from benchmark.reference import kanana as ref_kanana
from benchmark.reference import model as ref_model
from jodalrob_twotower_torch.config import ModelConfig, TrainConfig
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.models.text_encoder import KananaConfig, KananaEncoder, encoder_config
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.ops import moe
from jodalrob_twotower_torch.schema import (
    CategoricalSpec,
    EncodedTextSpec,
    NumericSpec,
    SideSchema,
    TwoTowerSchema,
)
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService

SMALL = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
         "num_hidden_layers": 3, "first_k_dense_replace": 1, "num_attention_heads": 4, "kv_lora_rank": 16,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
         "n_shared_experts": 1, "num_experts_per_tok": 2, "routed_scaling_factor": 2.448, "norm_topk_prob": True,
         "rope_theta": 1_000_000, "rms_norm_eps": 1e-6}
SEED = 4242


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_encoder(c: dict = SMALL, seed: int = SEED) -> KananaEncoder:
    enc = KananaEncoder(KananaConfig.from_dict(c))
    sd = enc.state_dict()
    drawn = {}
    for piece in gen_kanana.pieces(c):
        drawn.update(gen_kanana.draw(c, seed, piece, "cpu"))
    assert set(drawn) == set(sd)
    enc.load_state_dict(drawn, strict=True)
    return enc


def titles(n: int, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, 13, (n,), generator=g, dtype=torch.int32)
    ids = torch.randint(0, SMALL["vocab_size"], (n, 12), generator=g, dtype=torch.int32)
    return torch.where(torch.arange(12)[None, :] < lengths[:, None], ids, 0), lengths


def test_encoder_matches_the_reference():
    ids, lengths = titles(6)
    got = seeded_encoder()(ids, lengths)
    want = ref_kanana.encode(SMALL, SEED, ids, lengths)
    assert got.shape == (6, 64) and torch.allclose(got.norm(dim=1), torch.ones(6))
    assert (got - want).abs().max() < 1e-5


def test_config_validation_and_the_published_sizes():
    c = encoder_config("kanana2")
    assert (c.hidden_size, c.num_hidden_layers, c.n_routed_experts, c.num_experts_per_tok) == (2048, 48, 128, 6)
    assert encoder_config("kanana2", (("hidden_size", 64),)).hidden_size == 64
    with pytest.raises(ValueError, match="q_lora_rank"):
        KananaConfig.from_dict({"q_lora_rank": 1536})
    with pytest.raises(ValueError, match="unknown text encoder"):
        encoder_config("koelectra")


def test_correction_bias_selects_but_does_not_weigh():
    """A large bias on expert 0 puts it among every token's choices; its
    weight is still its own sigmoid score, normalised with the others'."""
    enc = seeded_encoder()
    mlp = enc.layers[1].mlp
    with torch.no_grad():
        mlp.gate.e_score_correction_bias.zero_()
        mlp.gate.e_score_correction_bias[0] = 10.0
    x = torch.randn(20, 64, generator=torch.Generator().manual_seed(1))
    resid = torch.zeros(20, 64)
    valid = torch.ones(20, dtype=torch.bool)
    tally = torch.zeros(8, 2, dtype=torch.int64)
    got = enc._moe(mlp, x, resid, valid, tally)
    s = torch.sigmoid(x @ mlp.gate.weight.T)
    unbiased = torch.topk(s, 2, dim=-1).indices
    assert not bool((unbiased == 0).any(dim=1).all())  # the bias changed the selection
    assert int(tally[0, 0]) == 20  # expert 0 took every token
    chosen = torch.topk(s + mlp.gate.e_score_correction_bias, 2, dim=-1).indices

    def expert(e, v):
        g, u = mlp.experts.gate_up_proj[e].split(32)
        return (F.silu(v @ g.T) * (v @ u.T)) @ mlp.experts.down_proj[e].T

    shared = mlp.shared_experts
    for weigh, close in ((s, True), (s + mlp.gate.e_score_correction_bias, False)):
        w = weigh.gather(1, chosen)
        w = w / w.sum(-1, keepdim=True) * 2.448
        want = torch.stack([
            sum(w[t, j] * expert(int(chosen[t, j]), x[t]) for j in range(2))
            + (F.silu(x[t] @ shared.gate_proj.weight.T) * (x[t] @ shared.up_proj.weight.T)) @ shared.down_proj.weight.T
            for t in range(20)])
        assert torch.allclose(got, want, atol=1e-5) is close


def test_a_title_is_the_same_alone_and_in_a_padded_batch():
    enc = seeded_encoder()
    ids, lengths = titles(5, seed=3)
    batch = enc(ids, lengths)
    for b in range(5):
        n = int(lengths[b])
        alone = enc(ids[b : b + 1, :n], lengths[b : b + 1])
        assert (alone[0] - batch[b]).abs().max() < 1e-6
    # padding ids do not matter
    noisy = torch.where(torch.arange(12)[None, :] < lengths[:, None], ids, 7)
    assert (enc(noisy, lengths) - batch).abs().max() < 1e-6


def test_the_dispatch_against_a_loop_over_pairs():
    g = torch.Generator().manual_seed(5)
    t, h, i, e, k = 13, 16, 8, 5, 2
    x = torch.randn(t, h, generator=g)
    ids = torch.randint(0, e, (t, k), generator=g)
    ids[3] = e  # a padded token: both its pairs dropped
    ids = ids.int().reshape(-1)
    w = torch.rand(t * k, generator=g)
    w_gu, w_d = torch.randn(e, 2 * i, h, generator=g), torch.randn(e, h, i, generator=g)
    shared, resid = torch.randn(t, h, generator=g), torch.randn(t, h, generator=g)
    tally = torch.zeros(e, 2, dtype=torch.int64)
    perm, inv, counts, offsets = moe.sort_pairs(ids, e, tally)
    assert torch.equal(perm[inv.long()], torch.arange(t * k, dtype=torch.int32))
    assert torch.equal(ids[perm.long()], torch.sort(ids).values) and counts.tolist()[-1] == 2
    assert torch.equal(tally[:, 0], counts[:e].long()) and torch.equal(tally[:, 1], (counts[:e] > 0).long())
    hh = moe.grouped_gate_up(x, w_gu, perm, counts, offsets, k)
    y = moe.grouped_down(hh, w_d, perm, counts, offsets, w)
    got = moe.combine(y, inv, ids, shared, resid, e)
    want = resid + shared
    for p in range(t * k):
        ex = int(ids[p])
        if ex == e:
            continue
        v = x[p // k]
        want[p // k] += w[p] * ((F.silu(v @ w_gu[ex, :i].T) * (v @ w_gu[ex, i:].T)) @ w_d[ex].T)
    assert torch.allclose(got, want, atol=1e-5)


def test_the_expert_tally_counts_each_real_tokens_pairs():
    enc = seeded_encoder()
    moe.reset_expert_tally()
    ids, lengths = titles(4, seed=9)
    enc(ids, lengths)
    tally = moe.expert_tally(2, 8)
    assert tally[:, :, 0].sum(1).tolist() == [2 * int(lengths.sum())] * 2
    assert (tally[:, :, 1] == (tally[:, :, 0] > 0)).all()


def _title_schema() -> TwoTowerSchema:
    col = EncodedTextSpec("title", "kanana2", 12, 64, tuple(sorted(SMALL.items())))
    notice = SideSchema("notice", ("id",), numeric=(NumericSpec("n0"), NumericSpec("n1"), NumericSpec("n2")),
                        categorical=(CategoricalSpec("c0", 20), CategoricalSpec("c1", 30)), encoded_text=(col,))
    company = SideSchema("company", ("id",), numeric=(NumericSpec("m0"),), categorical=(CategoricalSpec("d0", 25),))
    return TwoTowerSchema(notice=notice, company=company)


def test_schema_and_batch_carry_the_encoded_column():
    schema = _title_schema()
    assert TwoTowerSchema.from_dict(schema.to_dict()) == schema
    assert schema.notice.dense_dim == 3 and "encoded_text" not in schema.company.to_dict()
    ids, lengths = titles(2)
    moved = TowerBatch(np.zeros((2, 3), np.float32), np.zeros((2, 2), np.int32), ids.numpy(), lengths.numpy()).to("cpu")
    assert torch.equal(moved.text_ids, ids) and torch.equal(moved.text_lengths, lengths)
    assert TowerBatch(np.zeros((2, 3)), np.zeros((2, 2))).to("cpu").text_ids is None
    with pytest.raises(ValueError, match="at most one encoded text column"):
        second = dataclasses.replace(schema.notice.encoded_text[0], name="title2")
        dataclasses.replace(schema.notice, encoded_text=(*schema.notice.encoded_text, second))


def test_search_device_through_the_encoded_title_matches_the_reference():
    schema = _title_schema()
    cfg = TrainConfig(model=ModelConfig(compute_dtype="float32", dropout_rate=0.0))
    torch.manual_seed(0)
    model = TwoTowerModel(schema, cfg.model).init_weights(torch.Generator().manual_seed(2))
    sd = model.state_dict()
    for piece in gen_kanana.pieces(SMALL):
        for key, v in gen_kanana.draw(SMALL, SEED, piece, "cpu").items():
            sd[f"notice_tower.encoder_title.{key}"].copy_(v)
    g = torch.Generator().manual_seed(11)
    corpus = TowerBatch(torch.randn(300, 1, generator=g), torch.randint(0, 25, (300, 1), generator=g, dtype=torch.int32))
    state = FrozenState.from_model(model)
    emb = model.encode_company(corpus)
    service = RetrievalService(model, cfg, state, None, precomputed_corpus_emb=emb, device="cpu")
    ids, lengths = titles(7, seed=4)
    q = TowerBatch(torch.randn(7, 3, generator=g), torch.randint(0, 20, (7, 2), generator=g, dtype=torch.int32),
                   ids, lengths)
    scores, rows = service.search_device(q, k=5)
    w = {k: v.float() for k, v in sd.items()}
    m = {"dropout_rate": 0.0, "tower_hidden_dims": list(cfg.model.tower_hidden_dims), "use_batch_norm": True}
    side = {"num_numeric": 3, "text": {"title": 64}, "vocab_sizes": [20, 30]}
    pooled = ref_kanana.encode(SMALL, SEED, ids, lengths)
    ref_q = ref_model.tower(w, "notice", side, m, torch.cat([q.dense, pooled], 1), q.cat_ids, train=False)
    ref_c = ref_model.tower(w, "company", {"num_numeric": 1, "text": {}, "vocab_sizes": [25]}, m, corpus.dense,
                            corpus.cat_ids, train=False)
    ref_scores = ref_q @ ref_c.T
    best = torch.topk(ref_scores, 5, dim=1)
    assert (scores - best.values).abs().max() < 1e-5
    assert (torch.gather(ref_scores, 1, rows.long()) - best.values).abs().max() < 1e-5
    with pytest.raises(ValueError, match="inference form only"):
        model.notice_tower(q, train=True)


def test_the_counter_made_under_inference_mode_counts_outside_it():
    with torch.inference_mode():
        tally = moe.tally_buffer("cpu", 7, 3)
    tally[0, 0, 0] += 1  # an inference tensor would refuse the update
    assert not tally.is_inference() and int(moe.expert_tally(7, 3).sum()) == 1
    moe.reset_expert_tally()
