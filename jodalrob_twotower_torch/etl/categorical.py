"""Categorical feature preprocessing: vocab building + label encoding (port
of ``jodalrob_twotower_tpu/etl/categorical.py``, numpy only):

* vocab with special tokens ``[NULL]`` (id 0), ``[RARE]`` (id 1),
  ``[UNKNOWN]`` (id 2), then observed values by descending frequency;
* values seen fewer than ``rare_threshold`` times collapse to ``[RARE]``;
* transform: null -> [NULL], unseen -> [UNKNOWN], rare -> [RARE], else its
  id; optional ``{col}_is_null`` float flags;
* a model spec with ``input_dim`` (vocab size) per column, which is exactly
  what sizes the embedding tables downstream.

State serializes to the JAX package's JSON, so either package loads the
other's vocabs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

NULL_TOKEN = "[NULL]"
RARE_TOKEN = "[RARE]"
UNKNOWN_TOKEN = "[UNKNOWN]"
NULL_ID, RARE_ID, UNKNOWN_ID = 0, 1, 2
_N_SPECIAL = 3


@dataclasses.dataclass
class CategoricalColumnConfig:
    rare_threshold: int = 1  # values with count < threshold collapse to RARE
    # fractional alternative (the meta/*_config.json files use e.g. 0.001): the
    # count threshold becomes ceil(fraction * n_rows) at fit time
    rare_threshold_fraction: float | None = None
    max_vocab: int | None = None  # cap observed values (most frequent kept)
    null_flag: bool = True
    lowercase: bool = False
    strip: bool = True

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CategoricalColumnConfig":
        return cls(**dict(d))


def _is_null(v) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    s = str(v)
    return s == "" or s.lower() in ("nan", "none", "null")


class CategoricalPreprocessor:
    def __init__(self, configs: Mapping[str, CategoricalColumnConfig | Mapping] | None = None):
        self.configs: dict[str, CategoricalColumnConfig] = {
            k: v if isinstance(v, CategoricalColumnConfig) else CategoricalColumnConfig.from_dict(v)
            for k, v in (configs or {}).items()
        }
        self.vocabs: dict[str, dict[str, int]] = {}
        # values SEEN at fit but not kept in the vocab (below rare_threshold
        # or trimmed by max_vocab) -> map to [RARE] at transform; values
        # never seen -> [UNKNOWN]
        self.rares: dict[str, set[str]] = {}

    @property
    def fitted(self) -> bool:
        return bool(self.vocabs)

    def config_for(self, col: str) -> CategoricalColumnConfig:
        return self.configs.get(col, CategoricalColumnConfig())

    def _norm(self, v, cfg: CategoricalColumnConfig) -> str:
        s = str(v)
        if cfg.strip:
            s = s.strip()
        if cfg.lowercase:
            s = s.lower()
        return s

    # -- fit -----------------------------------------------------------------
    def fit(self, table: Mapping[str, np.ndarray], columns: list[str] | None = None) -> "CategoricalPreprocessor":
        columns = list(columns if columns is not None else table.keys())
        for col in columns:
            cfg = self.config_for(col)
            counts: dict[str, int] = {}
            for v in np.asarray(table[col], dtype=object):
                if _is_null(v):
                    continue
                s = self._norm(v, cfg)
                counts[s] = counts.get(s, 0) + 1
            # frequency-descending, then lexical for determinism
            items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            threshold = cfg.rare_threshold
            if cfg.rare_threshold_fraction is not None:
                threshold = max(
                    threshold,
                    int(np.ceil(cfg.rare_threshold_fraction * len(np.asarray(table[col])))),
                )
            kept = [v for v, c in items if c >= threshold]
            if cfg.max_vocab is not None:
                kept = kept[: cfg.max_vocab]
            vocab = {NULL_TOKEN: NULL_ID, RARE_TOKEN: RARE_ID, UNKNOWN_TOKEN: UNKNOWN_ID}
            for i, v in enumerate(kept):
                vocab[v] = _N_SPECIAL + i
            self.vocabs[col] = vocab
            kept_set = set(kept)
            self.rares[col] = {v for v, _ in items if v not in kept_set}
        return self

    # -- transform -----------------------------------------------------------
    def transform(self, table: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Returns {col: int32 ids [N]} (+ {col}_is_null float flags)."""
        if not self.fitted:
            raise RuntimeError("fit() before transform()")
        out: dict[str, np.ndarray] = {}
        for col, vocab in self.vocabs.items():
            if col not in table:
                raise KeyError(f"column {col!r} missing at transform time")
            cfg = self.config_for(col)
            raw = np.asarray(table[col], dtype=object)
            ids = np.empty(len(raw), dtype=np.int32)
            nulls = np.zeros(len(raw), dtype=np.float32)
            rares = self.rares.get(col, set())
            # seen-but-rare (below threshold / max_vocab-trimmed at fit)
            # -> [RARE]; genuinely unseen -> [UNKNOWN]
            for i, v in enumerate(raw):
                if _is_null(v):
                    ids[i] = NULL_ID
                    nulls[i] = 1.0
                else:
                    s = self._norm(v, cfg)
                    ids[i] = vocab.get(s, RARE_ID if s in rares else UNKNOWN_ID)
            if cfg.null_flag:
                out[f"{col}_is_null"] = nulls
            out[col] = ids
        return out

    def fit_transform(self, table) -> dict[str, np.ndarray]:
        return self.fit(table).transform(table)

    # -- model spec ------------------------------------------------------------
    def input_dims(self) -> dict[str, int]:
        """Vocab size per column -> sizes the embedding tables (the model
        spec JSON carries the same)."""
        return {col: len(vocab) for col, vocab in self.vocabs.items()}

    def model_spec(self) -> dict:
        return {
            "columns": [
                {"name": col, "input_dim": len(vocab), "special_tokens": _N_SPECIAL}
                for col, vocab in self.vocabs.items()
            ]
        }

    # -- persistence -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "configs": {k: dataclasses.asdict(v) for k, v in self.configs.items()},
            "vocabs": self.vocabs,
            "rares": {k: sorted(v) for k, v in self.rares.items()},
        }

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), ensure_ascii=False, indent=2))

    @classmethod
    def from_dict(cls, d: Mapping) -> "CategoricalPreprocessor":
        obj = cls(d.get("configs", {}))
        obj.vocabs = {k: dict(v) for k, v in d.get("vocabs", {}).items()}
        obj.rares = {k: set(v) for k, v in d.get("rares", {}).items()}
        return obj

    @classmethod
    def load(cls, path: str | Path) -> "CategoricalPreprocessor":
        return cls.from_dict(json.loads(Path(path).read_text()))
