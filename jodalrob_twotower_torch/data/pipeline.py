"""Batch pipeline: pair indices -> host PairBatches (port of
``jodalrob_twotower_tpu/data/pipeline.py``, the part the trainer uses).

``epoch_batches`` yields shuffled [B, 2] index batches with the same numpy
permutation as the reference, so both packages train on the same index
batches for the same seed. ``assemble_pair_batch`` gathers one aligned batch
from the host stores with numpy (the reference's native thread pool is a
speed-up of the same gather). The background assembler and device prefetch
of the reference are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.data.types import PairBatch


def assemble_pair_batch(notice_store: FeatureStore, company_store: FeatureStore, pairs: np.ndarray) -> PairBatch:
    """Gather one aligned batch. pairs: int [B, 2] rows into the stores."""
    pairs = np.asarray(pairs)
    return PairBatch(notice=notice_store.gather(pairs[:, 0]), company=company_store.gather(pairs[:, 1]))


def epoch_batches(
    pairs: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[np.ndarray]:
    """Yield [B, 2] index batches for one epoch."""
    n = pairs.shape[0]
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        yield pairs[order[start : start + batch_size]]
