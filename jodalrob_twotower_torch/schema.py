"""Typed feature schema for the two-tower model (port of
``jodalrob_twotower_tpu/schema.py``).

The frozen dataclasses drive table construction and the feature stores. The
JSON forms (``to_dict``/``from_dict``) are the JAX package's, so a schema
written by either package loads in the other. Parsing the reference's
``meta/metadata.csv`` stays in the JAX package until the ETL and CLI slices
of the port need it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping

# Default text-embedding width (koELECTRA-base sentence embeddings).
DEFAULT_TEXT_EMBED_DIM = 768


@dataclasses.dataclass(frozen=True)
class NumericSpec:
    """A single numeric feature column (already preprocessed to float32)."""

    name: str


@dataclasses.dataclass(frozen=True)
class CategoricalSpec:
    """A single categorical feature column (label-encoded int ids).

    ``vocab_size`` is the number of embedding rows to allocate. Ids outside
    ``[0, vocab_size)`` are clamped at lookup time, never crash.
    """

    name: str
    vocab_size: int

    def __post_init__(self) -> None:
        if self.vocab_size <= 0:
            raise ValueError(f"vocab_size for {self.name!r} must be positive, got {self.vocab_size}")


@dataclasses.dataclass(frozen=True)
class TextSpec:
    """A text feature, represented as a precomputed dense embedding column."""

    name: str
    embed_dim: int = DEFAULT_TEXT_EMBED_DIM


@dataclasses.dataclass(frozen=True)
class SideSchema:
    """Schema for one tower side (notice or company): table name, PK columns
    and the numeric/categorical/text feature lists."""

    table: str
    pk: tuple[str, ...]
    numeric: tuple[NumericSpec, ...] = ()
    categorical: tuple[CategoricalSpec, ...] = ()
    text: tuple[TextSpec, ...] = ()

    def __post_init__(self) -> None:
        names = [f.name for f in (*self.numeric, *self.categorical, *self.text)]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate feature names in {self.table!r} schema: {sorted(dupes)}")
        if not self.pk:
            raise ValueError(f"side schema {self.table!r} needs at least one PK column")

    @property
    def num_numeric(self) -> int:
        return len(self.numeric)

    @property
    def num_categorical(self) -> int:
        return len(self.categorical)

    @property
    def numeric_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.numeric)

    @property
    def categorical_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.categorical)

    @property
    def text_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.text)

    @property
    def vocab_sizes(self) -> tuple[int, ...]:
        return tuple(f.vocab_size for f in self.categorical)

    @property
    def text_dim(self) -> int:
        """Total width of concatenated text embeddings."""
        return sum(f.embed_dim for f in self.text)

    @property
    def dense_dim(self) -> int:
        """Width of the raw dense input vector (numeric ++ text embeddings)."""
        return self.num_numeric + self.text_dim

    def to_dict(self) -> dict:
        return {
            "table": self.table,
            "pk": list(self.pk),
            "numeric": [f.name for f in self.numeric],
            "categorical": [{"name": f.name, "vocab_size": f.vocab_size} for f in self.categorical],
            "text": [{"name": f.name, "embed_dim": f.embed_dim} for f in self.text],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "SideSchema":
        return cls(
            table=d["table"],
            pk=tuple(d["pk"]),
            numeric=tuple(NumericSpec(n) for n in d.get("numeric", ())),
            categorical=tuple(
                CategoricalSpec(c["name"], int(c["vocab_size"])) for c in d.get("categorical", ())
            ),
            text=tuple(
                TextSpec(t["name"], int(t.get("embed_dim", DEFAULT_TEXT_EMBED_DIM)))
                for t in d.get("text", ())
            ),
        )


@dataclasses.dataclass(frozen=True)
class PairSchema:
    """Schema of the positive-pair table linking the two sides."""

    table: str = "bid_two_tower"
    notice_fk: tuple[str, ...] = ("bidntceno", "bidntceord")
    company_fk: tuple[str, ...] = ("bizno",)


@dataclasses.dataclass(frozen=True)
class TwoTowerSchema:
    """Full schema: both sides plus the pair table."""

    notice: SideSchema
    company: SideSchema
    pairs: PairSchema = PairSchema()

    def side(self, name: str) -> SideSchema:
        if name == "notice":
            return self.notice
        if name == "company":
            return self.company
        raise KeyError(f"unknown side {name!r} (expected 'notice' or 'company')")

    def to_dict(self) -> dict:
        return {
            "notice": self.notice.to_dict(),
            "company": self.company.to_dict(),
            "pairs": dataclasses.asdict(self.pairs),
        }

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: Mapping) -> "TwoTowerSchema":
        pairs = d.get("pairs")
        return cls(
            notice=SideSchema.from_dict(d["notice"]),
            company=SideSchema.from_dict(d["company"]),
            pairs=PairSchema(
                table=pairs["table"],
                notice_fk=tuple(pairs["notice_fk"]),
                company_fk=tuple(pairs["company_fk"]),
            )
            if pairs
            else PairSchema(),
        )

    @classmethod
    def from_json(cls, path: str | Path) -> "TwoTowerSchema":
        return cls.from_dict(json.loads(Path(path).read_text()))


def tiny_synthetic_schema(
    *,
    n_categorical: int = 8,
    vocab_size: int = 1000,
    n_numeric: int = 16,
) -> TwoTowerSchema:
    """The CPU-runnable tiny synthetic schema (BASELINE.json config 1):
    8 categorical (vocab 1k) + 16 dense features per side."""
    def side(table: str, pk: tuple[str, ...]) -> SideSchema:
        return SideSchema(
            table=table,
            pk=pk,
            numeric=tuple(NumericSpec(f"num_{i}") for i in range(n_numeric)),
            categorical=tuple(CategoricalSpec(f"cat_{i}", vocab_size) for i in range(n_categorical)),
        )

    return TwoTowerSchema(
        notice=side("notice", ("bidntceno", "bidntceord")),
        company=side("company", ("bizno",)),
    )


def reference_shaped_schema(*, text_embed_dim: int = DEFAULT_TEXT_EMBED_DIM) -> TwoTowerSchema:
    """A schema with the reference production shape (SURVEY.md 2.2):
    notice = 29 numeric + 32 categorical + 1 text(768); company = 1 numeric +
    6 categorical. Vocab sizes synthetic (the real ones come from metadata.csv)."""
    return TwoTowerSchema(
        notice=SideSchema(
            table="notice",
            pk=("bidntceno", "bidntceord"),
            numeric=tuple(NumericSpec(f"num_{i}") for i in range(29)),
            categorical=tuple(CategoricalSpec(f"cat_{i}", 1000) for i in range(32)),
            text=(TextSpec("bidntcenm", text_embed_dim),),
        ),
        company=SideSchema(
            table="company",
            pk=("bizno",),
            numeric=(NumericSpec("num_0"),),
            categorical=tuple(CategoricalSpec(f"cat_{i}", 1000) for i in range(6)),
        ),
    )
