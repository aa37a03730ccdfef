"""ETL outputs -> ``SideSchema`` + ``FeatureStore`` (port of
``jodalrob_twotower_tpu/etl/to_feature_store.py``).

After the ETL (``etl.pipeline``) has produced preprocessed columns and a
manifest, derive the side schema (embedding-table sizes from the fitted
categorical vocabs plus the safety margin) and assemble the column-major
``FeatureStore`` the trainer consumes. The assembly
(:func:`feature_store_from_columns`) is shared by the parquet path
(:func:`feature_store_from_pipeline`) and the in-memory ETL
(``pipeline.preprocess_in_memory``), which needs no ``pyarrow``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

import numpy as np

from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.etl.pipeline import load_preprocessed
from jodalrob_twotower_torch.schema import (
    VOCAB_SAFETY_MARGIN,
    CategoricalSpec,
    NumericSpec,
    SideSchema,
    TextSpec,
)


def side_schema_from_manifest_dict(manifest: Mapping) -> SideSchema:
    """The SideSchema of an ETL manifest dict: numeric outputs (the
    generated *_is_null flags included) are numeric features; fitted vocab
    sizes plus the safety margin size the embedding tables; text columns
    carry the pipeline's embedding width."""
    return SideSchema(
        table=manifest["table"],
        pk=tuple(manifest["pk"]),
        numeric=tuple(NumericSpec(c) for c in manifest["numeric_outputs"]),
        categorical=tuple(
            CategoricalSpec(c, int(dim) + VOCAB_SAFETY_MARGIN)
            for c, dim in manifest["categorical_input_dims"].items()
        ),
        text=tuple(
            TextSpec(c, int(manifest["text_embed_dim"])) for c in manifest["text_outputs"]
        ),
    )


def side_schema_from_manifest(out_dir: str | Path, table_name: str) -> SideSchema:
    """:func:`side_schema_from_manifest_dict` of ``{table}_manifest.json``."""
    manifest = json.loads((Path(out_dir) / f"{table_name}_manifest.json").read_text())
    return side_schema_from_manifest_dict(manifest)


def feature_store_from_columns(schema: SideSchema, data: Mapping[str, np.ndarray]) -> FeatureStore:
    """A FeatureStore of preprocessed columns, keyed by the PK columns
    (composite PKs joined with '|', the FeatureStore's key semantics)."""
    n = len(next(iter(data.values())))
    if len(schema.pk) == 1:
        keys = np.asarray(data[schema.pk[0]]).astype(str)
    else:
        keys = np.asarray(
            ["|".join(str(data[c][i]) for c in schema.pk) for i in range(n)]
        )
    numeric = np.stack(
        [np.asarray(data[c], dtype=np.float32) for c in schema.numeric_names], axis=1
    ) if schema.numeric else None
    categorical = np.stack(
        [np.asarray(data[c], dtype=np.int32) for c in schema.categorical_names], axis=1
    ) if schema.categorical else None
    text = {t.name: np.asarray(data[t.name], dtype=np.float32) for t in schema.text} or None
    return FeatureStore.from_columns(
        schema, numeric=numeric, categorical=categorical, text=text, keys=keys
    )


def feature_store_from_pipeline(
    out_dir: str | Path, table_name: str, schema: SideSchema | None = None
) -> tuple[SideSchema, FeatureStore]:
    """Load preprocessed chunks into a FeatureStore (the schema from the
    manifest unless given)."""
    schema = schema or side_schema_from_manifest(out_dir, table_name)
    return schema, feature_store_from_columns(schema, load_preprocessed(out_dir, table_name))
