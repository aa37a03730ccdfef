"""The benchmark's files, found by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py`` (or, for a metric named
``<family>.<part>``, ``metrics/<family>.py``, the reader its family shares).

A cell (an entry of ``workloads``) joins one configuration and one traffic
mix; the traffic file names the driver (``drivers/<driver>.py``) that runs
it. Nothing here imports the program, so the manifest tests run without it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark (kind: configs, traffic, limits)."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(name: str, man: dict | None = None) -> dict:
    """The cell's manifest entry with its config, traffic and limits loaded,
    and the metrics it reports: ``end_to_end`` (for ``--trace 0``) and
    ``per_layer`` (for ``--trace 1``)."""
    man = man or manifest()
    entries = [w for w in man["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return {**w, "config_spec": load_json("configs", w["config"]), "traffic_spec": load_json("traffic", w["traffic"]),
            "limits": load_json("limits", name), "end_to_end": e2e, "per_layer": layer}


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py`` where there is one, else the family's
    ``metrics/<name before the first dot>.py``."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    """The metric's reader, ``read(summary) -> float | None``."""
    path = reader_path(metric)
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def derive(seed: int, purpose: str) -> int:
    """A 31-bit seed for one use (data, weights, sampling, ...) drawn from the
    run's ``--seed``, so every input follows from it alone."""
    words = [int(seed) % (1 << 64), *purpose.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0] >> 1)
