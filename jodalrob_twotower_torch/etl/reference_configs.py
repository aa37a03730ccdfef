"""Adapters for the reference-format ``meta/*_config.json`` preprocessing
configs (port of ``jodalrob_twotower_tpu/etl/reference_configs.py``).

Users migrating keep their existing config files
(``meta/{table}_{numeric,categorical,text}_config.json``) and load them here
into the typed configs.

Numeric keys: fill (strategy name OR a constant number), clip (percentile
pair), clip_abs (absolute pair), log1p, scale, add_flag. Categorical keys:
encoding_method ("label"), rare_threshold (a FRACTION of rows, e.g. 0.001).
Text keys: use, embedding_model, max_length, normalize, add_flag,
null_strategy.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

from jodalrob_twotower_torch.etl.categorical import CategoricalColumnConfig
from jodalrob_twotower_torch.etl.numeric import NumericColumnConfig
from jodalrob_twotower_torch.etl.text import TextColumnConfig


def _load(src) -> dict:
    if isinstance(src, (str, Path)):
        return json.loads(Path(src).read_text())
    return dict(src)


def numeric_configs_from_reference(src) -> dict[str, NumericColumnConfig]:
    out: dict[str, NumericColumnConfig] = {}
    for col, c in _load(src).items():
        fill = c.get("fill", "median")
        if isinstance(fill, (int, float)) and not isinstance(fill, bool):
            kw = {"fill": "constant", "fill_constant": float(fill)}
        else:
            kw = {"fill": str(fill)}
        if c.get("clip") is not None:
            kw["clip_percentiles"] = tuple(c["clip"])
        if c.get("clip_abs") is not None:
            kw["clip_values"] = tuple(c["clip_abs"])
        kw["log1p"] = bool(c.get("log1p", False))
        kw["scale"] = str(c.get("scale", "none"))
        kw["null_flag"] = bool(c.get("add_flag", True))
        if c.get("clip_to_null"):
            kw["clip_to_null"] = True
        out[col] = NumericColumnConfig(**kw)
    return out


def categorical_configs_from_reference(src) -> dict[str, CategoricalColumnConfig]:
    out: dict[str, CategoricalColumnConfig] = {}
    for col, c in _load(src).items():
        method = c.get("encoding_method", "label")
        if method != "label":
            raise ValueError(f"{col!r}: unsupported encoding_method {method!r}")
        rt = c.get("rare_threshold")
        out[col] = CategoricalColumnConfig(
            rare_threshold_fraction=float(rt) if rt is not None else None,
            null_flag=bool(c.get("add_flag", True)),
        )
    return out


def text_configs_from_reference(src) -> tuple[dict[str, TextColumnConfig], str | None]:
    """Returns (configs for used columns, embedding model name if given).

    The embedder is GLOBAL (one HF model per run), so per-column embedding_model values must
    agree — conflicting models would silently embed columns with the wrong
    one (last-wins), so that's an error. add_flag and null_strategy pass
    through to TextColumnConfig (etl/text.py implements both; non-'empty'
    null strategies error at transform time rather than being dropped)."""
    out: dict[str, TextColumnConfig] = {}
    model = None
    for col, c in _load(src).items():
        if not c.get("use", True):
            continue
        m = c.get("embedding_model")
        if m is not None:
            if model is not None and m != model:
                raise ValueError(
                    f"conflicting embedding_model values ({model!r} vs {m!r} for "
                    f"{col!r}): the embedder is global — split the run per model"
                )
            model = m
        out[col] = TextColumnConfig(
            max_length=int(c.get("max_length", 32)),
            normalize=bool(c.get("normalize", True)),
            add_flag=bool(c.get("add_flag", False)),
            null_strategy=str(c.get("null_strategy", "empty")),
        )
    return out, model
