"""The kanana2 title cell at the CPU's size (the encoder cut to hidden 64,
4 heads, latent 16, rope 8, 8 experts top-2 with 1 shared, 1 dense + 2 MoE
layers, vocabulary 512; the towers at their widths, in float32 where the
comparison is tight): the program's answers and pooled titles against the
reference, the control not correct, a planted fault caught, the traced
run's readers, and the titles' draw."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import faults, faults_kanana, judge, spec, trace
from benchmark.drivers import serve_title
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY

TINY_ENCODER = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
                "num_hidden_layers": 3, "first_k_dense_replace": 1, "num_attention_heads": 4, "kv_lora_rank": 16,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
                "n_shared_experts": 1, "num_experts_per_tok": 2}
NAME = "serve.kanana2_title_int8"


def tiny_title_cell(index: str = "int8", **model) -> dict:
    c = spec.cell(NAME)
    cfg = c["config_spec"] = copy.deepcopy(c["config_spec"])
    cfg.update(TINY_ENCODER)
    for enc in cfg["schema"]["notice"]["encoded_text"].values():
        enc["embed_dim"] = TINY_ENCODER["hidden_size"]
    cfg["train_config"]["model"].update(model)
    c["traffic_spec"] = {**c["traffic_spec"], **TINY["serve"], "n_clusters": 8, "index": index,
                         "title": {**c["traffic_spec"]["title"], "cluster_slice": 32}}
    return c


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_float32_program_matches_the_reference():
    """The exact index, so that the answers too agree to rounding."""
    run = serve_title.Run(tiny_title_cell("exact", compute_dtype="float32"), 20261018, "cpu")
    run.window(0.2)
    run.release()
    numbers = run.judge()
    assert numbers["text_gap"] < 1e-5 and numbers["score_gap"] < 1e-5 and numbers["rank_gap"] < 1e-5, numbers


def test_sound_program_is_correct_and_control_is_not():
    cell = tiny_title_cell()
    out = run_cell(cell, 31337, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    correct, checks = judge.verdict(serve_title.control(cell, 31337, "cpu"), cell["limits"], 0)
    assert not correct, checks


def test_planted_fault_is_not_correct():
    with faults.plant("altered_answer"):
        out = run_cell(tiny_title_cell(), 31337, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults_kanana.FAULTS)
def test_planted_encoder_fault_is_not_correct(fault):
    numbers = faults_kanana.readings(tiny_title_cell(), 31337, fault, 0.3, "cpu")
    correct, checks = judge.verdict(numbers, spec.cell(NAME)["limits"], 0)
    assert not correct and numbers["text_gap"] > spec.cell(NAME)["limits"]["text_gap"], checks


def test_text_gap_reads_the_arithmetic_with_the_routing_pinned():
    """The reference routed as the program routed: a float32 program reads
    as the reference does, and the pinned routes are the program's own."""
    cell = tiny_title_cell("exact", compute_dtype="float32")
    run = serve_title.Run(cell, 777, "cpu")
    run.window(0.2)
    run.release()
    picked, pooled, routes = run.check
    rows = torch.cat([torch.as_tensor(run.answers[b][0]) for b in picked]).numpy()
    assert len(routes) == 2 and routes[0].shape == (len(rows) * 32, 2)
    own = []
    ref = serve_title.reference_pooled(cell, 777, "cpu", rows, run.notices, record=own)
    assert all(torch.equal(r.long(), o) for r, o in zip(routes, own))
    gaps = serve_title.text_gaps(pooled, ref, ref)
    assert gaps["text_gap"] < 1e-5, gaps


def test_traced_run_reads_the_counter_and_the_flops():
    cell = tiny_title_cell()
    run = serve_title.Run(cell, 515151, "cpu")
    s = run.traced_window(trace.traced)
    n = cell["traffic_spec"]["trace_batches"]
    m = s["encoder"]
    assert m["batches"] == n and len(m["pairs"]) == 2 and len(m["load"][0]) == 8
    # every real token routes to top_k experts in each MoE layer
    tokens = sum(int(run.notices[3][run.answers[b][0]].sum()) for b in range(run.n_due - 2 * n, run.n_due - n))
    assert m["pairs"] == [2 * tokens, 2 * tokens]
    assert s["model_flops"] > 0 and s["flops_s"] == s["plain_window_s"]
    assert spec.reader("expert_load.serve_title")(s) >= 1.0
    # the CPU runs no card kernel: the rooflines and the span shares read nothing
    for name in ("moe_roofline", "moe_sort_roofline", "moe_combine_roofline", "text_host_share"):
        assert spec.reader(f"{name}.serve_title")(s) is None


def test_titles_follow_the_traffic():
    cell = spec.cell(NAME)
    traffic = {**cell["traffic_spec"], "n_notices": 4000}
    ids, lengths = serve_title.make_titles(cell["config_spec"], traffic, 99, "cpu")
    again, _ = serve_title.make_titles(cell["config_spec"], traffic, 99, "cpu")
    assert torch.equal(ids, again) and ids.shape == (4000, 32)
    assert int(lengths.min()) >= 6 and int(lengths.max()) <= 32 and 19 <= float(lengths.float().median()) <= 21
    assert 20.0 <= float(lengths.float().mean()) <= 22.0
    pad = torch.arange(32)[None, :] >= lengths[:, None]
    assert int(ids[pad].abs().sum()) == 0 and int(ids.max()) < cell["config_spec"]["vocab_size"]
    # the replayed clusters are gen.make_data's: notices of one cluster share their numeric centroid
    cl = serve_title.notice_clusters(cell["config_spec"]["schema"], traffic, 5, "cpu")
    from benchmark import gen
    dense = gen.make_data(cell["config_spec"]["schema"], {**traffic, "n_companies": 300}, 5, "cpu")["notice"][0]
    same = cl == cl[0]
    spread = (dense[same, :8] - dense[same, :8].mean(0)).std()
    assert float(spread) < 0.4  # the noise's 0.3, not the centroids' 1
