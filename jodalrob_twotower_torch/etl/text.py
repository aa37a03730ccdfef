"""Offline text embedding: an HF encoder -> masked mean-pooled sentence
vectors (port of ``jodalrob_twotower_tpu/etl/text.py``).

A HuggingFace AutoModel (default koELECTRA-base, overridable through the
environment variable ``TEXT_EMBEDDING_MODEL``), tokenization with per-column
max_length / lowercase / strip, masked mean pooling over the last hidden
state, optional L2 normalization, batched inference. The pooling runs in
torch on an explicit device: ``device=None`` means the card, and a missing
card raises (``device.resolve_device``).

``transformers`` is optional: it is imported inside ``HFTextEmbedder`` only.
When it is missing, or the model cannot be loaded (offline, no cache),
``TextPreprocessor`` falls back to the deterministic hash embedder, whose
vectors equal the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Mapping

import numpy as np
import torch

from jodalrob_twotower_torch.device import resolve_device

DEFAULT_MODEL = "monologg/koelectra-base-v3-discriminator"


@dataclasses.dataclass
class TextColumnConfig:
    max_length: int = 32
    lowercase: bool = False
    strip: bool = True
    batch_size: int = 64
    normalize: bool = True
    # emit a {col}_is_null float column alongside the embeddings (the
    # meta/*_text_config.json files' add_flag)
    add_flag: bool = False
    # how nulls embed; "empty" (the shipped value) embeds the empty string.
    # Other strategies are not implemented.
    null_strategy: str = "empty"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TextColumnConfig":
        return cls(**dict(d))


class HashTextEmbedder:
    """Deterministic dependency-free embedder (fallback / tests).

    Embeds each whitespace token by seeding a gaussian from its blake2 hash
    and mean-pooling: fixed dim, L2 norm, same text -> same vector, related
    texts share token mass, without a model. The vectors equal the JAX
    package's bit for bit.
    """

    def __init__(self, embed_dim: int = 768):
        self.embed_dim = embed_dim

    def encode(self, texts: list[str], cfg: TextColumnConfig) -> np.ndarray:
        out = np.zeros((len(texts), self.embed_dim), dtype=np.float32)
        for i, t in enumerate(texts):
            t = t.strip() if cfg.strip else t
            if cfg.lowercase:
                t = t.lower()
            tokens = t.split()[: cfg.max_length] or [""]
            acc = np.zeros(self.embed_dim, dtype=np.float64)
            for tok in tokens:
                seed = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little")
                acc += np.random.default_rng(seed).standard_normal(self.embed_dim)
            v = acc / len(tokens)
            if cfg.normalize:
                n = np.linalg.norm(v)
                v = v / n if n > 0 else v
            out[i] = v.astype(np.float32)
        return out


class HFTextEmbedder:
    """HuggingFace masked-mean-pooling sentence embedder on ``device`` (None
    means the card; without one it raises before the model is loaded)."""

    def __init__(self, model_name: str | None = None, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        from transformers import AutoModel, AutoTokenizer

        name = model_name or os.environ.get("TEXT_EMBEDDING_MODEL", DEFAULT_MODEL)
        self.tokenizer = AutoTokenizer.from_pretrained(name)
        self.model = AutoModel.from_pretrained(name)
        self.model.eval()
        self.model.to(self.device)
        self.embed_dim = int(self.model.config.hidden_size)

    def encode(self, texts: list[str], cfg: TextColumnConfig) -> np.ndarray:
        prepped = []
        for t in texts:
            t = t if isinstance(t, str) else ("" if t is None else str(t))
            if cfg.strip:
                t = t.strip()
            if cfg.lowercase:
                t = t.lower()
            prepped.append(t)
        chunks = []
        with torch.no_grad():
            for start in range(0, len(prepped), cfg.batch_size):
                batch = prepped[start : start + cfg.batch_size]
                enc = self.tokenizer(
                    batch,
                    padding=True,
                    truncation=True,
                    max_length=cfg.max_length,
                    return_tensors="pt",
                ).to(self.device)
                hidden = self.model(**enc).last_hidden_state  # [b, T, H]
                mask = enc["attention_mask"].unsqueeze(-1).float()
                pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
                if cfg.normalize:
                    pooled = torch.nn.functional.normalize(pooled, dim=-1)
                chunks.append(pooled.cpu().numpy().astype(np.float32))
        return np.concatenate(chunks, axis=0)


def auto_text_embedder(model_name: str | None = None, device=None, embed_dim: int = 768):
    """``HFTextEmbedder(model_name, device)``, or the hash embedder of
    ``embed_dim`` when the model cannot be loaded: ``transformers`` missing,
    or the weights not reachable (offline, no cache), which the
    ``from_pretrained`` factories raise as OSError or ValueError. A device
    that is not there raises (``resolve_device`` runs first)."""
    resolve_device(device)
    try:
        return HFTextEmbedder(model_name, device)
    except (ImportError, OSError, ValueError):
        return HashTextEmbedder(embed_dim)


class TextPreprocessor:
    """Per-column text -> embedding matrix, pluggable backend. With no
    ``embedder`` it takes ``auto_text_embedder()``: the HF model on the card,
    the hash embedder only when the model cannot be loaded; a missing card
    raises."""

    def __init__(
        self,
        configs: Mapping[str, TextColumnConfig | Mapping] | None = None,
        *,
        embedder=None,
        embed_dim: int = 768,
    ):
        self.configs = {
            k: v if isinstance(v, TextColumnConfig) else TextColumnConfig.from_dict(v)
            for k, v in (configs or {}).items()
        }
        self.embedder = embedder if embedder is not None else auto_text_embedder(embed_dim=embed_dim)

    @property
    def embed_dim(self) -> int:
        return self.embedder.embed_dim

    def config_for(self, col: str) -> TextColumnConfig:
        return self.configs.get(col, TextColumnConfig())

    def transform(
        self, table: Mapping[str, np.ndarray], columns: list[str] | None = None
    ) -> dict[str, np.ndarray]:
        """{col: float32 [N, embed_dim]} for each text column
        (+ {col}_is_null float flags when the config sets add_flag)."""
        columns = list(columns if columns is not None else self.configs.keys())
        out = {}
        for col in columns:
            cfg = self.config_for(col)
            if cfg.null_strategy != "empty":
                raise ValueError(
                    f"null_strategy {cfg.null_strategy!r} for {col!r} is not "
                    "implemented (only 'empty': nulls embed as the empty string)"
                )
            raw = np.asarray(table[col], dtype=object)
            is_null = np.array(
                [v is None or (isinstance(v, float) and np.isnan(v)) or str(v) == ""
                 for v in raw],
                dtype=np.float32,
            )
            texts = ["" if f else str(v) for v, f in zip(raw, is_null)]
            if cfg.add_flag:
                out[f"{col}_is_null"] = is_null
            out[col] = self.embedder.encode(texts, cfg)
        return out
