"""The program's host spans (``utils/profiling.span``): on the profiler's
trace as host events nested as the code nests, never as annotations that
reach the card; in the in-memory ring with each root's id and profiler
flag, stamped on the trace's clock; opened nowhere on the trace with no
session on; loading nothing at import; and the benchmark's span readers on
a hand-made record."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spec
from jodalrob_twotower_torch import profile_step
from jodalrob_twotower_torch.config import ModelConfig, TrainConfig
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.serving.index import HostCopy
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService
from jodalrob_twotower_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "jodalrob_twotower_torch"
PARENTS = {  # each span's parent span as the code nests them, None for a root
    "train.step": None, "train.batch": "train.step", "train.forward": "train.step",
    "train.backward": "train.step", "train.update": "train.step",
    "serve.search": None, "serve.encode": "serve.search", "serve.scan": "serve.search",
    "serve.rescore": "serve.search", "serve.copy": None,
}
OPENED = {
    "train": {"train.step", "train.batch", "train.forward", "train.backward", "train.update"},
    "exact": {"serve.search", "serve.encode", "serve.scan", "serve.copy"},
    "int8": {"serve.search", "serve.encode", "serve.scan", "serve.rescore", "serve.copy"},
}
N_STEPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _service(kind: str) -> tuple[RetrievalService, object]:
    ds = make_synthetic_dataset(n_notices=200, n_companies=300, n_pairs=500, n_clusters=8, seed=3)
    cfg = TrainConfig(model=ModelConfig(categorical_embedding_dim=8, dense_projection_dim=16,
                                        tower_hidden_dims=(32, 16), final_embedding_dim=16, dropout_rate=0.0))
    model = build_model(ds.schema, cfg).init_flax(torch.Generator().manual_seed(0))
    corpus = torch.randn(1000, 16, generator=torch.Generator().manual_seed(1))
    extra = dict(rescore_depth=40, rescore_dtype="bfloat16") if kind == "int8" else {}
    service = RetrievalService(model, cfg, FrozenState.from_model(model), None, index_kind=kind, corpus_chunk=256,
                               precomputed_corpus_emb=corpus, device="cpu", **extra)
    return service, ds.notice_store.gather(np.arange(8))


def _work(kind: str):
    """One call of the thing ``kind`` names, run under ``profile``: a sampled
    training call of N_STEPS steps, or one search and its copy."""
    if kind == "train":
        schema, notice_store, company_store, pairs = profile_step.setup_data("cpu", scale="tiny")
        fn, state = profile_step.prepare("full", schema, torch.device("cpu"), n_inner=N_STEPS, batch=64)
        return lambda: fn(state, 5, pairs, notice_store, company_store)
    service, batch = _service(kind)
    return lambda: HostCopy(*service.search_device(batch, 10)).result()


@pytest.fixture(scope="module", params=sorted(OPENED))
def traced(request):
    """(kind, the profiler, the roots the call left in the ring)."""
    work = _work(request.param)
    profiling._roots.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    return request.param, prof, profiling.span_record()


def _span_events(prof) -> list:
    return [e for e in prof.events() if e.name in profiling.SPANS]


def test_spans_are_host_events_nested_as_the_code_nests(traced):
    kind, prof, _ = traced
    events = _span_events(prof)
    assert {e.name for e in events} == OPENED[kind]
    for e in events:
        assert not e.is_user_annotation, e.name
        assert e.device_type == torch.autograd.DeviceType.CPU
        parent = e.cpu_parent
        while parent is not None and parent.name not in profiling.SPANS:
            parent = parent.cpu_parent
        assert (parent.name if parent is not None else None) == PARENTS[e.name], e.name
    raw = [e for e in prof.profiler.kineto_results.events() if e.name() in profiling.SPANS]
    assert raw and not any(e.is_user_annotation() for e in raw)


def test_record_holds_the_roots_with_ids_and_the_profiler_flag(traced):
    kind, _, record = traced
    if kind == "train":
        assert [r["name"] for r in record] == ["train.step"] * N_STEPS
        assert [r["id"] for r in record] == list(range(N_STEPS))  # the global step
        wanted = ["train.batch", "train.forward", "train.backward", "train.update"]
    else:
        assert [r["name"] for r in record] == ["serve.search", "serve.copy"]
        assert record[0]["id"] == 0  # the service's first request
        wanted = sorted(OPENED[kind] - {"serve.search", "serve.copy"}, key=["serve.encode", "serve.scan",
                                                                              "serve.rescore"].index)
    for r in record:
        assert r["profiled"] is True and r["start_ns"] <= r["end_ns"]
        if r["name"] in ("train.step", "serve.search"):
            assert [c["name"] for c in r["children"]] == wanted
        for c in r["children"]:
            assert c["parent"] == PARENTS[c["name"]] and c["root"] == r["id"]
            assert r["start_ns"] <= c["start_ns"] <= c["end_ns"] <= r["end_ns"] and c["self_ns"] >= 0
        inner = sum(c["end_ns"] - c["start_ns"] for c in r["children"])
        assert r["self_ns"] == r["end_ns"] - r["start_ns"] - inner


def test_record_starts_within_a_millisecond_of_the_trace(traced):
    """The in-memory stamps are on the clock of the profiler's host events."""
    _, prof, record = traced
    raw: dict[str, list[int]] = {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.name() in profiling.SPANS:
            raw.setdefault(e.name(), []).append(e.start_ns())
    mine: dict[str, list[int]] = {}
    for r in record:
        for s in [r, *r["children"]]:
            mine.setdefault(s["name"], []).append(s["start_ns"])
    assert mine.keys() == raw.keys()
    for name, starts in mine.items():
        assert len(starts) == len(raw[name])
        for a, b in zip(sorted(starts), raw[name]):
            assert abs(a - b) < 1_000_000, name


def test_untraced_roots_are_flagged_and_open_nothing_on_the_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"{name} opened a profiler range with no session on")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    work = _work("int8")
    profiling._roots.clear()
    work()
    work()
    record = profiling.span_record()
    assert [r["name"] for r in record] == ["serve.search", "serve.copy"] * 2
    assert [r["id"] for r in record if r["name"] == "serve.search"] == [0, 1]
    assert not any(r["profiled"] for r in record)


def test_ring_keeps_the_last_roots_and_no_more():
    profiling._roots.clear()
    for i in range(profiling.RING + 10):
        with profiling.span("serve.copy", root=i):
            pass
    record = profiling.span_record()
    assert profiling.RING == 8192 and len(record) == 8192
    assert record[0]["id"] == 10 and record[-1]["id"] == 8201
    profiling._roots.clear()


def test_a_child_with_no_root_open_is_kept_nowhere():
    profiling._roots.clear()
    with profiling.span("train.forward"):
        with profiling.span("train.backward"):
            pass
    assert profiling.span_record() == []


def test_import_loads_no_profiler_module():
    """The spans cost nothing at import: the package's training and serving
    modules load no module beyond the package's own that ``import torch``
    has not already loaded, ``torch.profiler``'s least of all."""
    code = ("import sys, torch; before = set(sys.modules); "
            "import jodalrob_twotower_torch.train.train_step, jodalrob_twotower_torch.serving.service; "
            "print(sorted(set(sys.modules) - before))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    added = ast.literal_eval(out.stdout.strip())
    assert added and all(m.split(".")[0] == "jodalrob_twotower_torch" for m in added), added
    assert not [m for m in added if m.startswith("torch.profiler")]


def _opened_names() -> list[str]:
    """The first argument of every ``span(...)`` call in the package."""
    names = []
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.append(node.args[0].value)
    return names


def test_every_span_is_opened_in_one_place_and_listed_in_perf_md():
    opened = _opened_names()
    assert sorted(opened) == sorted(profiling.SPANS)  # each name once, and no other
    perf = (REPO / "PERF.md").read_text()
    for name in profiling.SPANS:
        assert f"`{name}`" in perf, name


def _root(name, rid, start, end, children=(), profiled=False):
    kids = [{"name": n, "parent": name, "root": rid, "start_ns": a, "end_ns": b, "self_ns": b - a}
            for n, a, b in children]
    return {"name": name, "id": rid, "profiled": profiled, "start_ns": start, "end_ns": end,
            "self_ns": end - start - sum(k["end_ns"] - k["start_ns"] for k in kids), "children": kids}


RECORD = [
    # three untraced steps of 10, 20 and 30 ms whose update takes 4, 5 and 9 ms
    _root("train.step", 0, 0, 10_000_000, [("train.forward", 0, 3_000_000), ("train.update", 5_000_000, 9_000_000)]),
    _root("train.step", 1, 0, 20_000_000, [("train.update", 0, 5_000_000)]),
    _root("train.step", 2, 0, 30_000_000, [("train.update", 0, 9_000_000)]),
    # a traced step, slow, that no reader counts
    _root("train.step", 3, 0, 900_000_000, [("train.update", 0, 890_000_000)], profiled=True),
    _root("serve.search", 0, 0, 2_000_000),
    _root("serve.search", 1, 0, 6_000_000),
    _root("serve.search", 2, 0, 90_000_000, profiled=True),
    _root("serve.copy", 0, 0, 70_000_000),
]


@pytest.mark.parametrize("metric,value", [("step_host_ms.train", 20.0), ("update_host_share.train", 30.0),
                                          ("dispatch_ms.serve", 4.0), ("dispatch_ms.serve_int8", 4.0)])
def test_span_readers_read_the_untraced_roots(monkeypatch, metric, value):
    read = spec.reader(metric)
    monkeypatch.setattr(profiling, "span_record", lambda: RECORD)
    assert read({"busy_s": 1.0}) == pytest.approx(value)
    # no work on a card: the spans would time the work itself
    assert read({"busy_s": 0.0}) is None
    monkeypatch.setattr(profiling, "span_record", lambda: RECORD[3:4] + RECORD[6:])
    assert read({"busy_s": 1.0}) is None
    monkeypatch.setattr(profiling, "span_record", lambda: [])
    assert read({"busy_s": 1.0}) is None
