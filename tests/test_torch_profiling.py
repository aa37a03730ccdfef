"""The port's profiling utilities and step profiler: ``trace`` writing a
Chrome trace that ``device_table`` reads, ``device_table``'s busy time as
the union of the card's intervals, the measured peak cached per device, and
``python -m jodalrob_twotower_torch.profile_step``:
its variant list and config toggles equal ``scripts/profile_step.py``'s (read
from the script's source), and every variant runs one call of 2 steps at
B = 64 on the CPU with a finite loss and updated params."""

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from jodalrob_twotower_torch import profile_step
from jodalrob_twotower_torch.utils import profiling as t_prof

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """Steps at B = 64 run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_device_flops_estimate_is_measured_and_cached():
    peak = t_prof.device_flops_estimate(dtype="float32", n=64, device="cpu")
    assert peak > 0 and t_prof.device_flops_estimate(dtype="float32", n=64, device="cpu") == peak
    assert ("cpu", "float32", 64) in t_prof._PEAK_CACHE


def test_trace_writes_a_chrome_trace_the_table_reads(tmp_path):
    with t_prof.trace(tmp_path / "t") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    table = t_prof.device_table(prof, wall_us=1e3, repeats=1, host_top=3)
    assert table["busy_share"] is None and table["device_events_per_call"] == 0  # no card here
    assert len(table["host_top"]) == 3


def _device_event(name, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


def test_device_table_busy_is_the_union_of_the_cards_intervals():
    """Two kernels overlapping on two streams count once, a range an
    annotation puts on the card not at all, host events not at all."""
    events = [_device_event("k1", 0.0, 100.0), _device_event("k2", 50.0, 150.0), _device_event("k3", 300.0, 350.0),
              _device_event("window", 0.0, 1000.0, annotation=True),
              SimpleNamespace(name="aten::mm", device_type=torch.autograd.DeviceType.CPU, is_user_annotation=False,
                              time_range=SimpleNamespace(start=0.0, end=1000.0, elapsed_us=lambda: 1000.0))]
    prof = SimpleNamespace(events=lambda: events, key_averages=lambda: [])
    table = t_prof.device_table(prof, wall_us=1000.0, repeats=2)
    assert table["busy_share"] == pytest.approx(0.2)  # 200 us of the 1000, not the 250 the durations sum to
    assert table["device_ms_per_call"] == pytest.approx(0.1)
    assert table["device_events_per_call"] == 1.5
    assert table["top_ms"] == pytest.approx({"k1": 0.05, "k2": 0.05, "k3": 0.025})


def _script_constants() -> dict:
    tree = ast.parse((REPO / "scripts" / "profile_step.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("VARIANTS", "_MODEL_TOGGLES", "_LOSS_TOGGLES", "_OPT_TOGGLES", "B",
                                       "N_INNER", "N_DISPATCH")}


def test_variants_and_toggles_match_the_reference_script():
    ref = _script_constants()
    for name, value in ref.items():
        assert getattr(profile_step, name) == value, name
    assert set(profile_step.ABLATIONS) | {"full"} <= set(profile_step.VARIANTS)


@pytest.fixture(scope="module")
def tiny_data():
    return profile_step.setup_data("cpu", scale="tiny")


@pytest.mark.parametrize("name", profile_step.VARIANTS)
def test_each_variant_runs_two_steps(tiny_data, name):
    fn, state = profile_step.prepare(name, tiny_data[0], torch.device("cpu"), n_inner=2, batch=64)
    before = {k: v.clone() for k, v in state.params.items()}
    _, notice_store, company_store, pairs = tiny_data
    state, out = fn(state, 5, pairs, notice_store, company_store)
    assert out.shape == (2,) and torch.isfinite(out).all()
    assert state.step == 2
    # every variant feeds what it computed into the params
    assert any(not torch.equal(before[k], v) for k, v in state.params.items())


def test_profile_step_cli_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profile_step, "N_INNER", 2)  # steps per dispatch, as main reads it
    argv = ["--force-cpu", "--synthetic-scale", "tiny", "--batch-size", "64", "--dispatches", "1"]
    assert profile_step.main(argv + ["full", "no_opt", "fwd_only", "gather_only", "sample_only"]) == 0
    out = capsys.readouterr().out
    assert "attribution (ms/step): optimizer" in out and "sampling and the loop" in out
    assert profile_step.main(argv + ["--trace"]) == 0
    assert "no device events in the traced span" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown variant"):
        profile_step.main(argv + ["nope"])
