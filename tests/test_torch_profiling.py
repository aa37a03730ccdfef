"""The port's profiling utilities and step profiler against the JAX
package's: ``StepTimer``'s summary keys, ``utilization`` with a fixed peak,
``trace`` writing a Chrome trace that ``device_table`` reads, the measured
peak cached per device, and ``python -m jodalrob_twotower_torch.profile_step``:
its variant list and config toggles equal ``scripts/profile_step.py``'s (read
from the script's source), and every variant runs one call of 2 steps at
B = 64 on the CPU with a finite loss and updated params."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import profile_step
from jodalrob_twotower_torch.utils import profiling as t_prof
from jodalrob_twotower_tpu.utils import profiling as j_prof

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """Steps at B = 64 run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_step_timer_summary_matches_reference():
    summaries = []
    for module, fetch in ((t_prof, torch.ones(3)), (j_prof, np.ones(3))):
        timer = module.StepTimer()
        for _ in range(3):
            timer.start()
            timer.stop(fetch)
        summaries.append(timer.summary(batch_size=8))
        assert timer.summary().keys() == {"steps", "mean_ms", "p50_ms"}
    assert summaries[0].keys() == summaries[1].keys() == {"steps", "mean_ms", "p50_ms", "examples_per_sec"}
    assert summaries[0]["steps"] == summaries[1]["steps"] == 3
    timer = t_prof.StepTimer()
    timer.start()
    assert timer.stop({"loss": torch.zeros(())}) >= 0.0
    with pytest.raises(RuntimeError, match="before start"):
        timer.stop()


def test_utilization_with_a_fixed_peak(monkeypatch):
    for module in (t_prof, j_prof):
        monkeypatch.setattr(module, "device_flops_estimate", lambda **kw: 1e12)
        assert module.utilization(0.5, 1e11) == pytest.approx(0.2, rel=1e-12)


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
