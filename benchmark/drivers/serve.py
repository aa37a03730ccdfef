"""The serving driver: the program's ``RetrievalService`` over an index of
the whole company corpus, encoded at set-up by the program's own encoder
(``Evaluator.encode_corpus_device``), queried by batches of notices that
arrive from the host.

Arrivals are open or a backlog, as the traffic file says. Open
(``rate_per_s``): batch i is due at i / rate seconds into the window, and
goes to the service once fewer than ``max_in_flight`` batches are on the
card (``search_device`` and a pinned host copy, as ``service.qps_bench``
keeps them); its latency runs from its due time to its results in host
numpy, so a batch that waits for the card counts its wait, and every batch
due in the window is answered. A backlog (``"arrivals": "backlog"``): every
batch is due at the start, so the card always has ``max_in_flight`` batches
while the window is open; at its close no more go out, those on the card are
answered, and the rate is every answered query over the time to the last
answer. Each batch is then timed from its dispatch. Every answer is kept.

After the window the program's state is freed, a sample of the answered
batches drawn from the seed is re-encoded by the reference towers in
float32 and scanned exactly over the reference's own encoding of the whole
corpus, and the comparison reads the widest score and rank gaps.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchmark import flops, gen, judge, spec
from benchmark.drivers import common
from benchmark.drivers.common import Clock
from benchmark.reference import serve as ref_serve
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.evaluation.evaluator import Evaluator
from jodalrob_twotower_torch.serving.index import HostCopy
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService

POLL_S = 0.0002  # the loop's sleep between looks at arrivals and completions


class Run:
    def __init__(self, cell: dict, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg_spec, self.traffic = cell["config_spec"], cell["traffic_spec"]
        t = self.traffic
        self.k, self.batch = t["k"], t["batch_size"]
        clock = Clock()
        cfg = common.program_config(self.cfg_spec)
        data = gen.make_data(self.cfg_spec["schema"], t, spec.derive(seed, "data"), self.device)
        clock("data")
        model, w = common.program_model(self.cfg_spec, spec.derive(seed, "weights"), self.device)
        state = FrozenState.from_model(model)
        model.to("meta")
        del w
        corpus = Evaluator(model, cfg).encode_corpus_device(state, data["company"], t["n_companies"],
                                                            chunk=t["encode_chunk"])
        del data["company"]
        clock("corpus encoded")
        self.service = RetrievalService(
            model, cfg, state, None, index_kind=t["index"], corpus_chunk=t["corpus_chunk"],
            rescore_depth=t.get("rescore_depth"), rescore_dtype=t.get("rescore_dtype", "int8"),
            precomputed_corpus_emb=corpus, device=self.device)
        del corpus
        clock("index")
        # the notices arrive from the host, as a deployment's requests do
        self.notices = [x.cpu().numpy() for x in data["notice"]]
        self.rng = np.random.default_rng(spec.derive(seed, "queries"))
        self.answers: dict[int, tuple] = {}
        self.n_due = 0
        for _ in range(t.get("warm_batches", 3)):
            HostCopy(*self._search(self._rows())).result()
        self.phases = clock("notices to the host, warm batches")

    def _rows(self) -> np.ndarray:
        return self.rng.integers(0, self.notices[0].shape[0], self.batch)

    def _search(self, rows: np.ndarray):
        return self.service.search_device(TowerBatch(self.notices[0][rows], self.notices[1][rows]), self.k)

    @property
    def backlog(self) -> bool:
        if self.traffic["arrivals"] not in ("open", "backlog"):
            raise ValueError(f"arrivals must be 'open' or 'backlog', not {self.traffic['arrivals']!r}")
        return self.traffic["arrivals"] == "backlog"

    def _serve(self, seconds: float | None = None, n: int | None = None) -> dict:
        """Serves the batches due in ``seconds`` (open), or those sent while
        ``seconds`` last (backlog), or the first ``n``; returns the
        latencies (s), when the last answer came and the batches sent."""
        limit, backlog = self.traffic["max_in_flight"], self.backlog
        if not backlog:
            interval = 1.0 / self.traffic["rate_per_s"]
            horizon = seconds if seconds is not None else n * interval
        waiting, on_card, lat = collections.deque(), collections.deque(), []
        t0 = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter()
            if backlog:
                open_ = (n is None or i < n) and (seconds is None or now - t0 < seconds)
                if open_ and not waiting and len(on_card) < limit:
                    waiting.append((self.n_due, now, self._rows()))
                    self.n_due += 1
                    i += 1
            else:
                open_ = i * interval < horizon
                while i * interval < horizon and t0 + i * interval <= now:
                    waiting.append((self.n_due, t0 + i * interval, self._rows()))
                    self.n_due += 1
                    i += 1
            while on_card and (on_card[0][2].event is None or on_card[0][2].event.query()):
                b, due, copy, rows = on_card.popleft()
                scores, idx = copy.result()
                lat.append(time.perf_counter() - due)
                # kept as copies, so that the pinned buffers go back to the allocator's cache
                self.answers[b] = (rows, scores.copy(), idx.copy())
            while waiting and len(on_card) < limit:
                b, due, rows = waiting.popleft()
                on_card.append((b, due, HostCopy(*self._search(rows)), rows))
            if not open_ and not waiting and not on_card:
                return {"latencies": lat, "end": time.perf_counter() - t0, "batches": i}
            if not (backlog and open_ and len(on_card) < limit):
                time.sleep(POLL_S)

    def window(self, seconds: float) -> dict:
        due_before = self.n_due
        r = self._serve(seconds)
        lat = np.asarray(r["latencies"])
        return {"p95_ms": float(np.percentile(lat, 95) * 1e3),
                "latency_ms": (np.percentile(lat, [0, 50, 95, 100]) * 1e3).tolist(),
                "queries_per_s": len(lat) * self.batch / r["end"], "window_s": r["end"],
                "attempted": (self.n_due - due_before) * self.batch,
                "failed": (r["batches"] - len(r["latencies"])) * self.batch}

    def traced_window(self, traced) -> dict:
        """``trace_batches`` batches in each of the trace's passes. The model
        FLOPs a second: at a fixed rate the rate sets them, so they are taken
        over the card's busy seconds in the card-only pass; a backlog sets its
        own pace, so over the untraced pass's seconds."""
        n = self.traffic["trace_batches"]
        due_before = self.n_due
        runs, summary = traced(lambda: self._serve(n=n))
        per_batch = flops.serve_batch_flops(self.cfg_spec, self.batch, self.traffic["n_companies"])
        if self.backlog:
            summary.update(model_flops=per_batch * len(runs[0]["latencies"]), flops_s=summary["plain_window_s"])
        else:
            summary.update(model_flops=per_batch * len(runs[1]["latencies"]), flops_s=summary["busy_s"])
        summary.update(attempted=(self.n_due - due_before) * self.batch,
                       failed=sum(r["batches"] - len(r["latencies"]) for r in runs) * self.batch)
        return summary

    def release(self) -> None:
        self.service = None

    def judge(self) -> dict:
        """The program's answers on a sample of batches against the
        reference's exact float32 scan. Call after :meth:`release`."""
        return judge_answers(self.cell, self.seed, self.device, self.answers)


def sample_batches(answers: dict, n: int, seed: int) -> list[int]:
    keys = sorted(answers)
    pick = np.random.default_rng(spec.derive(seed, "check")).choice(len(keys), min(n, len(keys)), replace=False)
    return [keys[j] for j in sorted(pick)]


def reference_corpus(cell: dict, seed: int, device, prec: str = "f32"):
    """(reference weights, generated data, the corpus encoded by the reference)."""
    cfg_spec, traffic = cell["config_spec"], cell["traffic_spec"]
    data = gen.make_data(cfg_spec["schema"], traffic, spec.derive(seed, "data"), device)
    w = common.weights(cfg_spec, spec.derive(seed, "weights"), device)
    model = cfg_spec["train_config"]["model"]
    corpus = ref_serve.encode(w, "company", cfg_spec["schema"]["company"], model, *data["company"], prec=prec)
    del data["company"]
    return w, data, corpus


def reference_queries(cell, w, data, rows: np.ndarray, device, prec: str = "f32"):
    cfg_spec = cell["config_spec"]
    idx = torch.as_tensor(rows, device=device)
    dense, cat = data["notice"]
    return ref_serve.encode(w, "notice", cfg_spec["schema"]["notice"], cfg_spec["train_config"]["model"],
                            dense.index_select(0, idx), cat.index_select(0, idx), prec=prec)


def judge_answers(cell: dict, seed: int, device, answers: dict) -> dict:
    """``score_gap`` and ``rank_gap`` over the sampled batches; an answer
    that is malformed (rows out of range or repeated, scores not finite or
    not descending) reads as an infinite gap."""
    t = cell["traffic_spec"]
    picked = sample_batches(answers, t["check_batches"], seed)
    if not picked:
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    w, data, corpus = reference_corpus(cell, seed, device)
    rows = np.concatenate([answers[b][0] for b in picked])
    scores = torch.as_tensor(np.concatenate([answers[b][1] for b in picked]), device=device)
    served = torch.as_tensor(np.concatenate([answers[b][2] for b in picked]), device=device).long()
    if not answers_well_formed(scores, served, corpus.shape[0], t["k"]):
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    q = reference_queries(cell, w, data, rows, device)
    best, _ = ref_serve.exact_topk(q, corpus, t["k"])
    return judge.serve_numbers(scores, served, best, ref_serve.scores_of(q, corpus, served))


def answers_well_formed(scores, rows, n_rows: int, k: int) -> bool:
    if scores.shape[1] != k or rows.shape != scores.shape or not bool(torch.isfinite(scores).all()):
        return False
    if bool((rows < 0).any()) or bool((rows >= n_rows).any()):
        return False
    distinct = torch.sort(rows, dim=1).values.diff(dim=1).ne(0).all()
    return bool(distinct) and bool((scores.diff(dim=1) <= 0).all())


def control(cell: dict, seed: int, device, n_queries: int) -> dict:
    """The control's numbers: the reference one precision step down put in
    the program's place (float8 towers; the exact index's scan in TF32, the
    int8 index's first pass in int4 and its rescore in float8), on
    ``n_queries`` notices drawn from the seed, judged against the float32
    reference."""
    t = cell["traffic_spec"]
    rows = np.random.default_rng(spec.derive(seed, "queries")).integers(0, t["n_notices"], n_queries)
    w, data, corpus = reference_corpus(cell, seed, device)
    q = reference_queries(cell, w, data, rows, device)
    best, _ = ref_serve.exact_topk(q, corpus, t["k"])
    _, _, corpus_c = reference_corpus(cell, seed, device, prec="fp8")
    q_c = reference_queries(cell, w, data, rows, device, prec="fp8")
    if t["index"] == "int8":
        s_c, i_c = ref_serve.int4_rescored_topk(q_c, corpus_c, t["k"], t["rescore_depth"])
    else:
        s_c, i_c = ref_serve.exact_topk(q_c, corpus_c, t["k"], prec="tf32")
    return judge.serve_numbers(s_c, i_c, best, ref_serve.scores_of(q, corpus, i_c))
