"""BENCHMARK.json against the rules of its format, the frozen FLOP and
roofline counts against hand-worked values, and the import rules."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import flops, peaks, spec
from benchmark.rooflines import k1_onehot_lookup, k2_table_grad, k4_row_gather, k6_ce_fwd, k11_ce_bwd

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
                         + [w[k] for w in MAN["workloads"] for k in ("config", "traffic")])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if metric in MAN["end_to_end"] else
                                                   {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert spec.reader_path(metric["name"]).is_file()
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(MAN["workloads"])


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_by_each_cell(metric):
    """Every per-layer metric moves one end-to-end metric that each of its
    cells reports."""
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", [w["name"] for w in MAN["workloads"]]):
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    """Each cell finds its config, traffic, driver and limits by name, and
    reports setup_s, one more end-to-end metric and one per-layer metric."""
    c = spec.cell(cell["name"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert (spec.HERE / "drivers" / f"{c['traffic_spec']['driver']}.py").is_file()
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    assert c["limits"] and all(v > 0 for v in c["limits"].values())


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"].startswith(MAN["paths"][0] + "/") and (spec.ROOT / c["file"]).is_file()
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]


def test_step_flops_hand_worked():
    """97.63 GFLOP a step at B=8192 for the reference's towers, 87.17 for
    config 3's, and the frozen copy agrees with the program's rule."""
    from benchmark.drivers.common import program_config, program_schema
    from jodalrob_twotower_torch.utils.flops import train_step_model_flops

    for name, want in (("ref_shaped", 97_630_814_208), ("scaled_tables", 87_174_414_336)):
        c = spec.load_json("configs", name)
        assert flops.train_step_flops(c, 8192) == want
        assert train_step_model_flops(program_schema(c["schema"]), program_config(c), 8192) == want


def test_roofline_counts_hand_worked():
    """The least times the kernel checks give (PERF.md's kernel table)."""
    assert peaks.bound_s(**k6_ce_fwd.cost(8192, 128)) * 1e3 == pytest.approx(0.017371, rel=1e-4)
    assert peaks.bound_s(**k11_ce_bwd.cost(8192, 128)) * 1e3 == pytest.approx(0.052113, rel=1e-4)
    # K2 notice: 8192 x 32 ids, D=32, 32,768 rows: 22,021,120 bytes
    assert k2_table_grad.nbytes(8192, 32, 32, 32768) == 22_021_120
    # K1 company: every one of 6,144 rows read
    assert k1_onehot_lookup.nbytes(8192, 6, 32, 6144, 6144) == 8192 * 6 * 4 + 48 * 4 + 6144 * 128 + 8192 * 6 * 64
    # K4 at 8192 x 8 distinct f32 rows of 64: 33,816,576 bytes
    assert k4_row_gather.nbytes(65536, 65536, 64) == 33_816_576
    assert peaks.bound_s(nbytes=33_816_576) * 1e3 == pytest.approx(0.010095, rel=1e-4)


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    """Top-level module names compared whole: the port's name begins with
    the JAX package's."""
    assert not _imports(path) & {"jax", "jaxlib", "flax", "jodalrob_twotower_tpu"}


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "jodalrob_twotower_torch" not in _imports(path)


def test_reader_falls_back_to_its_family():
    """A metric's own reader wins; else the one its family shares."""
    assert spec.reader_path("train_card_ms_per_step").name == "train_card_ms_per_step.py"
    assert spec.reader_path("idle_share.some_later_cell").name == "idle_share.py"
    assert spec.reader("bigtable_examples_per_s")({"examples_per_s": 3.0}) == 3.0
    assert spec.reader("host_examples_per_s.train")({"host_examples_per_s": 2.0}) == 2.0
