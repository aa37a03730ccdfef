"""Shared pieces of the benchmark's own tests: cells cut to a size the CPU
holds (the config's widths kept, rows and batch cut; the large tables'
vocabularies cut to 5,000 ids a feature), and the marker of the tests that
need the card."""

from __future__ import annotations

import copy

import pytest

from benchmark import spec

TINY = {
    # the loss's rounding noise shrinks as 1/sqrt(B); at B=4096 the cells' limits hold on the CPU too
    "train": {"n_notices": 8000, "n_companies": 8000, "n_pairs": 32000, "n_clusters": 16, "batch_size": 4096,
              "steps_per_call": 4, "warm_calls": 1, "trace_calls": 2},
    "serve": {"n_notices": 2000, "n_companies": 20000, "n_clusters": 16, "encode_chunk": 4096, "corpus_chunk": 4096,
              "batch_size": 16, "k": 10, "rate_per_s": 50.0, "warm_batches": 1, "check_batches": 4,
              "trace_batches": 4},
}
TINY_VOCAB = 5000


def tiny_cell(name: str, **sections) -> dict:
    """``name``'s cell at the CPU's size; ``sections`` update the config's
    train_config sections (e.g. model={"compute_dtype": "float32"})."""
    c = spec.cell(name)
    c["config_spec"] = copy.deepcopy(c["config_spec"])
    for side in c["config_spec"]["schema"].values():
        side["vocab_sizes"] = [min(v, TINY_VOCAB) for v in side["vocab_sizes"]]
    for section, fields in sections.items():
        c["config_spec"]["train_config"][section].update(fields)
    c["traffic_spec"] = {**c["traffic_spec"], **TINY[c["traffic_spec"]["driver"]]}
    return c


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
