"""Embedding-row gather (port of the plain path of
``jodalrob_twotower_tpu/ops/embedding_lookup.py``).

Clamping happens in the caller (models/embedding.py); this gathers
already-valid absolute rows. The reference's Pallas ``_gather_kernel`` runs
only with ``MeshConfig.use_pallas_lookup=True``, off the default path, and
is still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Gather table rows in the table's dtype. table: [R, D]; rows: int [...]; -> [..., D]."""
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[1])
