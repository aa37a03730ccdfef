"""The frozen FLOP count of the kanana2 title encoder and the roofline
counts of the MoE dispatch kernels against hand-worked values."""

from __future__ import annotations

import pytest

from benchmark import flops, flops_kanana, peaks, spec
from benchmark.rooflines import moe_combine, moe_experts, moe_sort

CFG = spec.load_json("configs", "kanana2_title")


def test_token_flops_hand_worked():
    """Position 0: a layer's attention 2 x 2048 x (32 x 192 + 512 + 64) +
    2 x 512 x 32 x 256 + 2 x 4096 x 2048 + 2 x 32 x 320 x 1 = 52,711,424;
    the dense MLP 6 x 2048 x 6144 = 75,497,472; an MoE layer's router,
    6 routed and 2 shared experts 2 x 2048 x 128 + 8 x 6 x 2048 x 768 =
    76,021,760. 48 attentions + 1 dense + 47 MoE = 6,178,668,544."""
    assert flops_kanana.token_flops(CFG, 0) == 48 * 52_711_424 + 75_497_472 + 47 * 76_021_760 == 6_178_668_544
    # each later position attends over one more key: 2 x 32 x (192 + 128) a layer
    assert flops_kanana.token_flops(CFG, 5) - flops_kanana.token_flops(CFG, 4) == 48 * 20_480
    assert flops_kanana.title_flops(CFG, 3) == 3 * 6_178_668_544 + 48 * 20_480 * 3


def test_serve_batch_flops_adds_the_tower_and_the_scan():
    side = flops_kanana.reference_side(CFG["schema"]["notice"])
    assert side["text"] == {"bidntcenm": 2048}
    model = CFG["train_config"]["model"]
    # the notice tower: 2 x 29 x 128 + 2 x 2048 x 128 + 2 x 2 x 128 x 512 + 2 x (512 + 1024) x 256 + 2 x 256 x 128
    tower = flops.tower_forward_flops(side, model)
    assert tower == 7_424 + 524_288 + 262_144 + 786_432 + 65_536
    got = flops_kanana.serve_batch_flops(CFG, [1, 2], 10)
    assert got == flops_kanana.title_flops(CFG, 1) + flops_kanana.title_flops(CFG, 2) + 2 * tower + 2 * 2 * 10 * 128


def test_moe_roofline_counts_hand_worked():
    """32,418 pairs over 128 experts (the kernel check's batch): gate/up
    4 x 2048 x 768 x 32,418 = 203,956,420,608 FLOPs, bytes 128 x 1536 x
    2048 x 2 + 32,418 x 2816 x 2 = 987,884,544; down half the FLOPs, bytes
    128 x 2048 x 768 x 2 + the same rows."""
    up, down = moe_experts.cost(32_418, 128, 2048, 768)
    assert up == {"flops": 203_956_420_608, "nbytes": 805_306_368 + 182_578_176}
    assert down == {"flops": 101_978_210_304, "nbytes": 402_653_184 + 182_578_176}
    assert peaks.bound_s(**up) * 1e3 == pytest.approx(0.294891, rel=1e-4)  # bytes-bound
    assert peaks.bound_s(**down) * 1e3 == pytest.approx(0.17470, rel=1e-4)
    assert moe_sort.nbytes(49_152, 128) == 49_152 * 12 + 129 * 8
    assert moe_combine.nbytes(8192, 32_418, 6, 2048) == 8192 * (48 + 12_288) + 32_418 * 4096


def test_readers_stay_silent_without_the_counter():
    for name in ("moe_roofline", "moe_sort_roofline", "moe_combine_roofline", "expert_load", "text_host_share"):
        assert spec.reader(f"{name}.serve_title")({"device_us_by_name": {}}) is None
    s = {"encoder": {"load": [[1, 1, 2], [3, 0, 0]]}}
    assert spec.reader("expert_load.serve_title")(s) == pytest.approx((1.5 + 3.0) / 2)
