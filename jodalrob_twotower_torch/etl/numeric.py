"""Numeric feature preprocessing: fit statistics, transform to float32 (port
of ``jodalrob_twotower_tpu/etl/numeric.py``, numpy only), on plain numpy
columns:

fit (per column):
  * fill value — median / mean / mode / constant
  * clip bounds — percentile (e.g. [1, 99]) or absolute values
  * log1p offset — auto-shift so the minimum maps to >= 0
  * scale stats — zscore (mean/std) or minmax (min/max)

transform (per column, in fit-frozen order):
  * optional ``{col}_is_null`` flag column (1.0 where the raw value was null)
  * fill nulls -> clip (or clip_to_null: out-of-bounds becomes null first)
  * -> log1p -> scale -> float32

State serializes to the JAX package's JSON, so a preprocessor fitted by
either package loads and transforms identically in the other. Columns seen
at fit but missing at transform raise.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Mapping

import numpy as np


@dataclasses.dataclass
class NumericColumnConfig:
    fill: str = "median"  # median | mean | mode | constant
    fill_constant: float = 0.0
    clip_percentiles: tuple[float, float] | None = None  # e.g. (1.0, 99.0)
    clip_values: tuple[float | None, float | None] | None = None
    clip_to_null: bool = False  # out-of-bounds -> treated as null (then filled)
    log1p: bool = False
    scale: str = "zscore"  # zscore | minmax | none
    null_flag: bool = True

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NumericColumnConfig":
        kw = dict(d)
        for key in ("clip_percentiles", "clip_values"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)


@dataclasses.dataclass
class _ColumnStats:
    fill_value: float
    clip_lo: float | None
    clip_hi: float | None
    log_offset: float  # added before log1p so argument >= 0
    center: float  # zscore mean / minmax min
    spread: float  # zscore std / minmax range (>= tiny)


class NumericPreprocessor:
    def __init__(self, configs: Mapping[str, NumericColumnConfig | Mapping] | None = None):
        self.configs: dict[str, NumericColumnConfig] = {
            k: v if isinstance(v, NumericColumnConfig) else NumericColumnConfig.from_dict(v)
            for k, v in (configs or {}).items()
        }
        self.stats: dict[str, _ColumnStats] = {}

    @property
    def fitted(self) -> bool:
        return bool(self.stats)

    def config_for(self, col: str) -> NumericColumnConfig:
        return self.configs.get(col, NumericColumnConfig())

    # -- fit -----------------------------------------------------------------
    def fit(self, table: Mapping[str, np.ndarray], columns: list[str] | None = None) -> "NumericPreprocessor":
        columns = list(columns if columns is not None else table.keys())
        for col in columns:
            raw = np.asarray(table[col], dtype=np.float64)
            cfg = self.config_for(col)
            valid = raw[np.isfinite(raw)]
            if valid.size == 0:
                valid = np.zeros(1)

            if cfg.fill == "median":
                fill = float(np.median(valid))
            elif cfg.fill == "mean":
                fill = float(np.mean(valid))
            elif cfg.fill == "mode":
                vals, counts = np.unique(valid, return_counts=True)
                fill = float(vals[np.argmax(counts)])
            elif cfg.fill == "constant":
                fill = float(cfg.fill_constant)
            else:
                raise ValueError(f"unknown fill {cfg.fill!r} for {col!r}")

            lo = hi = None
            if cfg.clip_percentiles is not None:
                lo = float(np.percentile(valid, cfg.clip_percentiles[0]))
                hi = float(np.percentile(valid, cfg.clip_percentiles[1]))
            elif cfg.clip_values is not None:
                lo = None if cfg.clip_values[0] is None else float(cfg.clip_values[0])
                hi = None if cfg.clip_values[1] is None else float(cfg.clip_values[1])

            # pipeline order fixed: fill -> clip -> log1p -> scale; stats for
            # the scaler are computed on the transformed valid values
            x = valid.copy()
            if lo is not None or hi is not None:
                if cfg.clip_to_null:
                    mask = np.ones_like(x, bool)
                    if lo is not None:
                        mask &= x >= lo
                    if hi is not None:
                        mask &= x <= hi
                    x = np.where(mask, x, fill)
                else:
                    x = np.clip(x, lo if lo is not None else -np.inf, hi if hi is not None else np.inf)
            offset = 0.0
            if cfg.log1p:
                mn = float(np.min(x)) if x.size else 0.0
                offset = -mn if mn < 0 else 0.0
                x = np.log1p(x + offset)

            if cfg.scale == "zscore":
                center, spread = float(np.mean(x)), float(np.std(x))
            elif cfg.scale == "minmax":
                center = float(np.min(x))
                spread = float(np.max(x) - np.min(x))
            elif cfg.scale == "none":
                center, spread = 0.0, 1.0
            else:
                raise ValueError(f"unknown scale {cfg.scale!r} for {col!r}")
            spread = spread if spread > 1e-12 else 1.0
            self.stats[col] = _ColumnStats(fill, lo, hi, offset, center, spread)
        return self

    # -- transform -----------------------------------------------------------
    def transform(self, table: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Returns {col: float32 [N]} (+ {col}_is_null flags where configured),
        in fit order."""
        if not self.fitted:
            raise RuntimeError("fit() before transform()")
        out: dict[str, np.ndarray] = {}
        for col, st in self.stats.items():
            if col not in table:
                raise KeyError(f"column {col!r} missing at transform time")
            raw = np.asarray(table[col], dtype=np.float64)
            cfg = self.config_for(col)
            # null = NaN/None only (pandas semantics): ±inf is DATA — it flows into
            # the clip like any outlier rather than being fill-replaced
            # with a null flag. (Fit statistics still exclude non-finite
            # values so an inf cannot poison a mean/percentile.)
            null = np.isnan(raw)
            x = np.where(null, st.fill_value, raw)
            if st.clip_lo is not None or st.clip_hi is not None:
                if cfg.clip_to_null:
                    oob = np.zeros_like(x, bool)
                    if st.clip_lo is not None:
                        oob |= x < st.clip_lo
                    if st.clip_hi is not None:
                        oob |= x > st.clip_hi
                    null = null | oob
                    x = np.where(oob, st.fill_value, x)
                else:
                    x = np.clip(
                        x,
                        st.clip_lo if st.clip_lo is not None else -np.inf,
                        st.clip_hi if st.clip_hi is not None else np.inf,
                    )
            if cfg.log1p:
                x = np.log1p(np.maximum(x + st.log_offset, 0.0))
            if cfg.scale == "zscore":
                x = (x - st.center) / st.spread
            elif cfg.scale == "minmax":
                x = (x - st.center) / st.spread
            if cfg.null_flag:
                out[f"{col}_is_null"] = null.astype(np.float32)
            out[col] = x.astype(np.float32)
        return out

    def fit_transform(self, table) -> dict[str, np.ndarray]:
        return self.fit(table).transform(table)

    @property
    def output_columns(self) -> list[str]:
        cols = []
        for col in self.stats:
            if self.config_for(col).null_flag:
                cols.append(f"{col}_is_null")
            cols.append(col)
        return cols

    # -- persistence -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "configs": {k: dataclasses.asdict(v) for k, v in self.configs.items()},
            "stats": {k: dataclasses.asdict(v) for k, v in self.stats.items()},
        }

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: Mapping) -> "NumericPreprocessor":
        obj = cls(d.get("configs", {}))
        obj.stats = {k: _ColumnStats(**v) for k, v in d.get("stats", {}).items()}
        return obj

    @classmethod
    def load(cls, path: str | Path) -> "NumericPreprocessor":
        return cls.from_dict(json.loads(Path(path).read_text()))
