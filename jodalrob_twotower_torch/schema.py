"""Typed feature schema for the two-tower model (port of
``jodalrob_twotower_tpu/schema.py``).

The frozen dataclasses drive table construction and the feature stores. The
JSON forms (``to_dict``/``from_dict``) are the JAX package's, so a schema
written by either package loads in the other. A schema is built
programmatically, from a JSON dict, or from the reference-format
``meta/metadata.csv`` (Korean or English headers) with
:func:`schema_from_metadata_csv`: used columns only, PK columns apart, SQL
numeric types numeric, text/char types categorical when flagged so (their
vocab from the category count plus a margin) and text otherwise.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Mapping, Sequence

# SQL types treated as numeric features.
_NUMERIC_SQL_TYPES = {"bigint", "double precision", "numeric", "integer", "real", "smallint"}

# Safety margin added on top of the observed category count when sizing
# embedding tables; an unknown count takes the fallback.
VOCAB_SAFETY_MARGIN = 10
VOCAB_FALLBACK = 1000

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
class EncodedTextSpec:
    """A text feature that a named encoder produces on the card from the
    text's token ids and lengths (``TowerBatch.text_ids`` /
    ``text_lengths``, right-padded to ``max_length``), in place of a stored
    vector. ``encoder`` names the architecture (``models/text_encoder.py``:
    "kanana2"); ``config`` holds (key, value) pairs of its config that
    differ from the published one (empty: the published model);
    ``embed_dim`` is the pooled width, the encoder's hidden size."""

    name: str
    encoder: str = "kanana2"
    max_length: int = 32
    embed_dim: int = 2048
    config: tuple[tuple[str, object], ...] = ()

    def __post_init__(self) -> None:
        if self.max_length <= 0:
            raise ValueError(f"max_length for {self.name!r} must be positive, got {self.max_length}")

    def to_dict(self) -> dict:
        d = {"name": self.name, "encoder": self.encoder, "max_length": self.max_length, "embed_dim": self.embed_dim}
        if self.config:
            d["config"] = dict(self.config)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "EncodedTextSpec":
        return cls(d["name"], d.get("encoder", "kanana2"), int(d.get("max_length", 32)),
                   int(d.get("embed_dim", 2048)), tuple(sorted(dict(d.get("config", {})).items())))


@dataclasses.dataclass(frozen=True)
class SideSchema:
    """Schema for one tower side (notice or company): table name, PK columns
    and the numeric/categorical/text feature lists."""

    table: str
    pk: tuple[str, ...]
    numeric: tuple[NumericSpec, ...] = ()
    categorical: tuple[CategoricalSpec, ...] = ()
    text: tuple[TextSpec, ...] = ()
    encoded_text: tuple[EncodedTextSpec, ...] = ()

    def __post_init__(self) -> None:
        names = [f.name for f in (*self.numeric, *self.categorical, *self.text, *self.encoded_text)]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate feature names in {self.table!r} schema: {sorted(dupes)}")
        if not self.pk:
            raise ValueError(f"side schema {self.table!r} needs at least one PK column")
        if len(self.encoded_text) > 1:
            raise ValueError(f"side schema {self.table!r}: at most one encoded text column, "
                             f"got {[f.name for f in self.encoded_text]}")

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
            **({"encoded_text": [f.to_dict() for f in self.encoded_text]} if self.encoded_text else {}),
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
            encoded_text=tuple(EncodedTextSpec.from_dict(t) for t in d.get("encoded_text", ())),
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


# -- metadata.csv parsing (the reference-format input) ---------------------------

# Header aliases: Korean (the reference's meta/metadata.csv) or English.
_HEADER_ALIASES: dict[str, tuple[str, ...]] = {
    "table": ("테이블명", "table"),
    "column": ("컬럼명", "컬럼", "column", "필드명"),
    "dtype": ("타입", "데이터타입", "type", "data_type"),
    "use": ("사용 여부", "사용여부", "use"),
    "pk": ("pk",),
    "is_categorical": ("범주형 여부", "범주형여부", "categorical", "is_categorical"),
    "n_categories": ("범주 갯수", "범주갯수", "n_categories", "category_count"),
}


def _norm(s: str) -> str:
    return re.sub(r"\s+", "", s).strip().lower().lstrip("\ufeff")


def _resolve_headers(fieldnames: Sequence[str]) -> dict[str, str]:
    norm_to_raw = {_norm(f): f for f in fieldnames}
    resolved: dict[str, str] = {}
    for key, aliases in _HEADER_ALIASES.items():
        for alias in aliases:
            raw = norm_to_raw.get(_norm(alias))
            if raw is not None:
                resolved[key] = raw
                break
        else:
            if key != "n_categories":  # the category count is optional
                raise KeyError(f"metadata csv missing a header for {key!r} (aliases {aliases})")
    return resolved


def _truthy(value: object) -> bool:
    return str(value or "").strip().lower() in {"y", "yes", "true", "1", "t"}


def _is_numeric_sql(dtype: str) -> bool:
    return dtype.strip().lower() in _NUMERIC_SQL_TYPES


def _is_textual_sql(dtype: str) -> bool:
    s = dtype.strip().lower()
    if s == "text" or s.startswith("text"):
        return True
    if s.startswith("character varying") or s.startswith("varchar"):
        return True
    # fixed-width char types, e.g. character(1)
    return re.fullmatch(r"(character|char)\s*\(\s*\d+\s*\)", s) is not None


def classify_columns(table: str, metadata_path: str | Path) -> dict[str, list]:
    """Classify a table's used columns into pk/numeric/categorical/text.

    Returns ``{"pk": [...], "numeric": [...], "categorical": [(name,
    n_categories or None)], "text": [...]}``; columns of other SQL types
    (dates, booleans, ...) are left out."""
    path = Path(metadata_path)
    with path.open(newline="", encoding="utf-8-sig") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            raise ValueError(f"empty metadata csv: {path}")
        hdr = _resolve_headers(reader.fieldnames)
        pk: list[str] = []
        numeric: list[str] = []
        categorical: list[tuple[str, int | None]] = []
        text: list[str] = []
        for row in reader:
            if str(row.get(hdr["table"], "")).strip() != table:
                continue
            if not _truthy(row.get(hdr["use"])):
                continue
            name = str(row[hdr["column"]]).strip()
            if _truthy(row.get(hdr["pk"])):
                pk.append(name)
                continue
            dtype = str(row.get(hdr["dtype"], "")).strip()
            if _is_numeric_sql(dtype):
                numeric.append(name)
            elif _is_textual_sql(dtype):
                if _truthy(row.get(hdr["is_categorical"])):
                    raw_count = row.get(hdr["n_categories"]) if "n_categories" in hdr else None
                    try:
                        count = int(float(raw_count)) if raw_count not in (None, "") else None
                    except (TypeError, ValueError):
                        count = None
                    categorical.append((name, count))
                else:
                    text.append(name)
    return {"pk": pk, "numeric": numeric, "categorical": categorical, "text": text}


def vocab_rows(n_categories: int | None) -> int:
    """Embedding rows for an observed category count (margin + fallback)."""
    if n_categories is None or n_categories <= 0:
        return VOCAB_FALLBACK
    return n_categories + VOCAB_SAFETY_MARGIN


def side_schema_from_metadata_csv(
    table: str,
    metadata_path: str | Path,
    *,
    text_embed_dim: int = DEFAULT_TEXT_EMBED_DIM,
    text_columns: Iterable[str] | None = None,
) -> SideSchema:
    """Build a :class:`SideSchema` for one table from a metadata csv.

    ``text_columns`` optionally restricts which classified text columns get
    an embedding; by default every classified text column does."""
    cls = classify_columns(table, metadata_path)
    wanted_text = set(text_columns) if text_columns is not None else None
    return SideSchema(
        table=table,
        pk=tuple(cls["pk"]),
        numeric=tuple(NumericSpec(n) for n in cls["numeric"]),
        categorical=tuple(CategoricalSpec(n, vocab_rows(c)) for n, c in cls["categorical"]),
        text=tuple(
            TextSpec(n, text_embed_dim)
            for n in cls["text"]
            if wanted_text is None or n in wanted_text
        ),
    )


def schema_from_metadata_csv(
    metadata_path: str | Path,
    *,
    notice_table: str = "notice",
    company_table: str = "company",
    text_embed_dim: int = DEFAULT_TEXT_EMBED_DIM,
    notice_text_columns: Iterable[str] | None = None,
    company_text_columns: Iterable[str] | None = None,
) -> TwoTowerSchema:
    """Build the full two-tower schema from a reference-format metadata csv."""
    return TwoTowerSchema(
        notice=side_schema_from_metadata_csv(
            notice_table, metadata_path, text_embed_dim=text_embed_dim, text_columns=notice_text_columns
        ),
        company=side_schema_from_metadata_csv(
            company_table, metadata_path, text_embed_dim=text_embed_dim, text_columns=company_text_columns
        ),
    )


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
