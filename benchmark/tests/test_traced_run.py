"""A traced run and a serving backlog at the CPU's size: the three passes
of the trace give the readers what they read, and a backlog sends batches
only while its window is open and answers every one it sent."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import trace
from benchmark.drivers import serve, train
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell


def test_traced_training_run():
    out = run_cell(tiny_cell("train.ref_shaped"), 424242, 0.3, True, "cpu")
    # judged as an untraced run is (the limits are the card's, at its batch of 8,192)
    assert [c[0] for c in out["checks"]] == ["loss_gap", "update_gap"]
    # the CPU runs no kernel of the card: only the host-clock rate is read,
    # and the step's share of the peak, taken over the card's busy time, is left out
    assert set(out["metrics"]) == {"host_examples_per_s.train"}
    assert out["metrics"]["host_examples_per_s.train"]["value"] > 0
    assert out["device"]["busy_s"] == 0.0 and out["breakdown"]["idle_gaps"]
    assert out["attempted"] == 3 * 2 * 4  # three passes of trace_calls calls of steps_per_call steps


def test_backlog_answers_what_it_sent():
    cell = tiny_cell("serve.int8_10m")
    assert cell["traffic_spec"]["arrivals"] == "backlog"
    run = serve.Run(cell, 515151, "cpu")
    r = run.window(0.3)
    assert r["failed"] == 0 and r["attempted"] == len(run.answers) * run.batch > 0
    assert r["window_s"] >= 0.3 and r["queries_per_s"] == r["attempted"] / r["window_s"]
    traced = run.traced_window(trace.traced)
    assert traced["attempted"] == 3 * cell["traffic_spec"]["trace_batches"] * run.batch
    assert traced["model_flops"] > 0 and traced["flops_s"] == traced["plain_window_s"]


def test_card_window_runs_whole_calls_and_reads_no_card_on_the_cpu():
    """The host-paced cell's window traces its calls on the card: on the CPU
    it still runs whole calls for its seconds and leaves the card's time out."""
    cell = tiny_cell("train.ref_shaped")
    run = train.Run(cell, 616161, "cpu")
    assert run.card_window
    r = run.window(0.3)
    assert r["card_ms_per_step"] is None and r["card_busy_s"] == 0.0 and r["window_s"] >= 0.3
    assert r["failed"] == 0 and r["attempted"] % cell["traffic_spec"]["steps_per_call"] == 0 and r["attempted"] > 0
    assert not train.Run(tiny_cell("train.scaled_dense"), 616161, "cpu").card_window


def _event(start, end, card=True, annotation=False):
    dev = torch.autograd.DeviceType.CUDA if card else torch.autograd.DeviceType.CPU
    return SimpleNamespace(device_type=lambda: dev, is_user_annotation=lambda: annotation,
                           start_ns=lambda: start, duration_ns=lambda: end - start)


def test_busy_is_the_union_of_the_cards_intervals():
    """Kernels overlapping on two streams count once; host events and
    annotations' ranges on the card do not count."""
    events = [_event(0, 10), _event(5, 20), _event(30, 40), _event(0, 100, card=False),
              _event(0, 100, annotation=True), _event(35, 38)]
    assert trace.busy_ns(events) == 30
