"""Observability (port of ``jodalrob_twotower_tpu/utils/profiling.py``, its
``MetricsLogger``): a structured JSONL metrics stream, one row per call of
:meth:`MetricsLogger.log` with the step, the seconds since the logger was
made and the metric dict. Numbers, numpy scalars and 0-dim tensors are
written as floats, as the reference writes its arrays.

The step timer, the profiler trace and the utilization estimate of the
reference are not ported yet.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Mapping

import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")
        self._start = time.time()

    def log(self, step: int, metrics: Mapping[str, object], **extra) -> None:
        row = {
            "step": int(step),
            "time": round(time.time() - self._start, 3),
            **{k: (float(v) if isinstance(v, (int, float, np.floating)) or hasattr(v, "item") else v)
               for k, v in metrics.items()},
            **extra,
        }
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path: str | Path) -> list[dict]:
        with Path(path).open() as fh:
            return [json.loads(line) for line in fh if line.strip()]
