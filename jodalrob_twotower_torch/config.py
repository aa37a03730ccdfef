"""Typed configuration (port of ``jodalrob_twotower_tpu/config.py``).

The fields, defaults, validation and JSON forms are the JAX package's, so a
config written by either package loads in the other. Fields that only a
later slice of the port reads (the loss, optimizer, data pipeline, mesh and
checkpoint knobs) are kept so that such a file round-trips; the comments
say what each does in the reference.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Tower architecture (reference: scripts/train.py:101-111, base_tower.py:49-99)."""

    categorical_embedding_dim: int = 32
    # Width each raw dense block (numeric / each text embedding) is projected
    # to, by a learned layer, before entering the tower MLP.
    dense_projection_dim: int = 128
    tower_hidden_dims: tuple[int, ...] = (512, 256)
    final_embedding_dim: int = 128
    dropout_rate: float = 0.1
    # PRNG implementation of the dropout stream in the reference:
    # "auto" | "threefry" | "rbg". The port keeps the field so that a config
    # file means the same in both packages, but draws every dropout mask
    # from one torch.Generator per step whichever value is set
    # (train/train_step.step_generator).
    dropout_rng_impl: str = "auto"
    use_batch_norm: bool = True
    # Compute dtype for tower matmuls; params stay float32.
    compute_dtype: str = "bfloat16"
    # Embedding-table gradient path: "auto" | "dense" | "scatter".
    embedding_grad: str = "auto"
    # Embedding-table FORWARD path: "auto" | "gather" | "onehot". "auto"
    # resolves to the hand-written lookup kernel for CUDA tensors when the
    # unified table is within the dense envelope (models/embedding.py),
    # and to the plain gather elsewhere.
    embedding_lookup: str = "auto"

    def __post_init__(self) -> None:
        if self.dropout_rng_impl not in ("auto", "threefry", "rbg"):
            raise ValueError(
                f"dropout_rng_impl must be 'auto', 'threefry' or 'rbg', got "
                f"{self.dropout_rng_impl!r}"
            )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got "
                f"{self.compute_dtype!r}"
            )
        if self.embedding_grad not in ("auto", "dense", "scatter"):
            raise ValueError(
                f"embedding_grad must be 'auto', 'dense' or 'scatter', got "
                f"{self.embedding_grad!r}"
            )
        if self.embedding_lookup not in ("auto", "gather", "onehot"):
            raise ValueError(
                f"embedding_lookup must be 'auto', 'gather' or 'onehot', "
                f"got {self.embedding_lookup!r}"
            )

    @property
    def hidden_dims(self) -> tuple[int, ...]:
        return tuple(self.tower_hidden_dims)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training objective (reference: two_tower_train_task.py:99-158)."""

    # "cross_entropy" = bidirectional in-batch-negatives softmax CE;
    # "cosine_embedding" = pairwise cosine margin loss.
    loss_type: str = "cross_entropy"
    temperature: float = 1.0
    label_smoothing: float = 0.0
    cosine_margin: float = 0.0
    # Fused dot + log-softmax CE kernel: True, False or "auto".
    use_fused_logits: bool | str = "auto"

    def __post_init__(self) -> None:
        if self.use_fused_logits not in (True, False, "auto"):
            raise ValueError(
                "use_fused_logits must be True, False or 'auto', got "
                f"{self.use_fused_logits!r}"
            )


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer/schedule (reference: scripts/train.py:231-242)."""

    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    num_epochs: int = 1
    warmup_ratio: float = 0.05
    # Dense params use adamw; embedding tables use rowwise adagrad unless
    # set to "adamw".
    embedding_optimizer: str = "rowwise_adagrad"
    embedding_learning_rate: float | None = None  # defaults to learning_rate
    adagrad_init_accumulator: float = 0.1
    adagrad_eps: float = 1e-10
    gradient_clip_norm: float | None = None
    # dtype of AdamW's first moment for the dense params; the second moment
    # stays float32 in both modes.
    adam_moment_dtype: str = "float32"
    # Duplicate-id semantics of the sparse-tables rowwise Adagrad:
    # "exact" | "per_occurrence".
    sparse_duplicate_handling: str = "exact"

    def __post_init__(self) -> None:
        if self.adam_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "adam_moment_dtype must be 'float32' or 'bfloat16', got "
                f"{self.adam_moment_dtype!r}"
            )
        if self.sparse_duplicate_handling not in ("exact", "per_occurrence"):
            raise ValueError(
                "sparse_duplicate_handling must be 'exact' or "
                f"'per_occurrence', got {self.sparse_duplicate_handling!r}"
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference: scripts/train.py:86-100)."""

    batch_size: int = 256
    test_split: float = 0.2
    shuffle_seed: int = 42
    pair_limit: int | None = 1_000_000
    # Streaming chunk size when reading parquet pair chunks.
    chunk_size: int = 1_000_000
    # Number of batches prefetched onto the device.
    prefetch: int = 2
    drop_remainder: bool = True
    # dtype of the device-resident dense feature block: "auto" (the model's
    # compute dtype), "float32" or "bfloat16".
    device_store_dtype: str = "auto"
    # Draw each step's batch on the device from the resident pair set.
    sample_on_device: bool = False

    def __post_init__(self) -> None:
        if self.device_store_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"device_store_dtype must be 'auto', 'float32' or "
                f"'bfloat16', got {self.device_store_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh / parallelism. The port runs one device until the parallel
    slice; these fields keep the reference's meaning."""

    # Axis sizes; -1 on the data axis means "all remaining devices".
    data_axis: int = -1
    model_axis: int = 1
    # Embedding-table sharding: "auto" | "replicated" | "gspmd_rows" | "shard_map".
    embedding_sharding: str = "auto"
    # Use the reference's Pallas gather kernel for the lookup.
    use_pallas_lookup: bool = False
    # Device-resident feature-store placement: "replicated" | "rows".
    store_sharding: str = "replicated"
    # Compressed dense-gradient all-reduce: "none" | "int16" | "bf16".
    grad_compression: str = "none"
    # In-batch-negatives scope when grad_compression is on: "local" | "global".
    compressed_negatives: str = "local"

    def __post_init__(self) -> None:
        if self.embedding_sharding not in (
            "auto", "replicated", "gspmd_rows", "shard_map"
        ):
            raise ValueError(
                "embedding_sharding must be one of 'auto', 'replicated', "
                f"'gspmd_rows', 'shard_map'; got {self.embedding_sharding!r}"
            )
        if self.store_sharding not in ("replicated", "rows"):
            raise ValueError(
                "store_sharding must be 'replicated' or 'rows'; "
                f"got {self.store_sharding!r}"
            )
        if self.grad_compression not in ("none", "int16", "bf16"):
            raise ValueError(
                "grad_compression must be 'none', 'int16' or 'bf16'; "
                f"got {self.grad_compression!r}"
            )
        if self.compressed_negatives not in ("local", "global"):
            raise ValueError(
                "compressed_negatives must be 'local' or 'global'; "
                f"got {self.compressed_negatives!r}"
            )


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpointing (reference: scripts/train.py:497-534)."""

    output_dir: str = "output/models"
    save_best: bool = True
    save_final: bool = True
    save_every_epoch: bool = True
    keep_n: int = 3
    # Checkpoint the train state every N steps (0 = off).
    save_every_steps: int = 0


_SECTIONS = {
    "model": ModelConfig,
    "loss": LossConfig,
    "optimizer": OptimizerConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
    "checkpoint": CheckpointConfig,
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level config bundling all subsystems."""

    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    data: DataConfig = DataConfig()
    mesh: MeshConfig = MeshConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    log_interval: int = 20
    metadata_path: str | None = None
    results_csv: str = "train_results.csv"
    # structured per-epoch metrics stream (JSONL); empty disables
    metrics_jsonl: str = ""
    # O(batch) sparse-table training path for huge embedding tables
    sparse_tables: bool = False
    # With sparse_tables: one batched table update per n_inner-step window
    sparse_defer_updates: bool = False
    seed: int = 42

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrainConfig":
        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown {klass.__name__} field {k!r}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return klass(**kwargs)

        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            kwargs[f.name] = build(_SECTIONS[f.name], v) if f.name in _SECTIONS else v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str | Path) -> "TrainConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def replace(self, **kwargs) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)
