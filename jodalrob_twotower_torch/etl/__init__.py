"""Offline ETL of the port (port of ``jodalrob_twotower_tpu/etl/``): the
numeric, categorical and text preprocessors, the pipeline from raw tables to
preprocessed chunks and feature stores, the reference-format config
adapters, chunked parquet conversion, and the SQL shim and PostgreSQL
write-back. ``python -m jodalrob_twotower_torch.etl`` is its CLI
(``etl/cli.py``)."""

from jodalrob_twotower_torch.etl.categorical import CategoricalPreprocessor  # noqa: F401
from jodalrob_twotower_torch.etl.numeric import NumericPreprocessor  # noqa: F401
from jodalrob_twotower_torch.etl.pipeline import run_pipeline  # noqa: F401
