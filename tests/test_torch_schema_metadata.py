"""The port's reference-format ``metadata.csv`` parsing (``schema.py``)
against the JAX package's, on the same files: the classification, the
vocab sizing and the schema built from it equal (``to_dict``), with Korean
and English headers, and the same ``KeyError`` on a missing header."""

import json

import pytest

from jodalrob_twotower_torch import schema as tschema
from jodalrob_twotower_tpu import schema as jschema

# the fixture of tests/test_schema.py (Korean headers)
METADATA_KO = """\
테이블명,컬럼명,타입,사용 여부,PK,범주형 여부,범주 갯수
notice,bidntceno,character varying(40),Y,Y,,
notice,bidntceord,character varying(3),Y,Y,,
notice,presmptprce,numeric,Y,,,
notice,asignbdgtamt,bigint,Y,,,
notice,bidmethdnm,character varying(100),Y,,Y,7
notice,bidntcenm,text,Y,,,
notice,unused_col,text,N,,,
notice,ignored_date,timestamp,Y,,,
company,bizno,character varying(10),Y,Y,,
company,empl_cnt,integer,Y,,,
company,region_cd,character(2),Y,,Y,17
company,nocount_cat,varchar(5),Y,,Y,
"""

# English headers, a BOM, spacing and case variants, an unparsable count
METADATA_EN = (
    "﻿table,Column,data_type,Use,PK,Is_Categorical,category_count\n"
    "notice,id,varchar(8),yes,true,,\n"
    "notice,amount,double precision,Y,,,\n"
    "notice,rate,real,1,,,\n"
    "notice,kind,char(1),t,,y,3\n"
    "notice,odd,character varying(4),Y,,Y,many\n"
    "notice,title,text,Y,,N,\n"
    "notice,flag,boolean,Y,,,\n"
    "company,cid,varchar(10),Y,Y,,\n"
    "company,n_emp,smallint,Y,,,\n"
    "company,sector,varchar(4),Y,,Y,0\n"
)


@pytest.fixture(params=["ko", "en"])
def metadata(request, tmp_path):
    p = tmp_path / "metadata.csv"
    p.write_text(METADATA_KO if request.param == "ko" else METADATA_EN, encoding="utf-8")
    return p


@pytest.mark.parametrize("table", ["notice", "company", "absent"])
def test_classify_columns_matches_the_reference(metadata, table):
    assert tschema.classify_columns(table, metadata) == jschema.classify_columns(table, metadata)


@pytest.mark.parametrize("n", [None, 0, -3, 1, 7, 990])
def test_vocab_rows_matches_the_reference(n):
    assert tschema.vocab_rows(n) == jschema.vocab_rows(n)
    assert (tschema.VOCAB_SAFETY_MARGIN, tschema.VOCAB_FALLBACK) == (jschema.VOCAB_SAFETY_MARGIN,
                                                                      jschema.VOCAB_FALLBACK)


@pytest.mark.parametrize("kw", [{}, {"text_embed_dim": 16}, {"notice_text_columns": ()},
                                {"notice_text_columns": ("bidntcenm",), "company_text_columns": ()}])
def test_schema_from_metadata_csv_matches_the_reference(metadata, kw):
    tables = {"notice_table": "notice", "company_table": "company"}
    got = tschema.schema_from_metadata_csv(metadata, **tables, **kw)
    want = jschema.schema_from_metadata_csv(metadata, **tables, **kw)
    assert got.to_dict() == want.to_dict()
    # a schema written by either package loads in the other
    path = metadata.parent / "schema.json"
    got.to_json(path)
    assert jschema.TwoTowerSchema.from_json(path) == want
    assert json.loads(path.read_text()) == json.loads(json.dumps(want.to_dict()))


def test_side_schema_from_metadata_csv_matches_the_reference(metadata):
    for table in ("notice", "company"):
        got = tschema.side_schema_from_metadata_csv(table, metadata, text_embed_dim=32)
        want = jschema.side_schema_from_metadata_csv(table, metadata, text_embed_dim=32)
        assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("drop", ["테이블명", "컬럼명", "타입", "사용 여부", "PK", "범주형 여부"])
def test_missing_header_raises_the_same_key_error(tmp_path, drop):
    lines = [line.split(",") for line in METADATA_KO.splitlines()]
    col = lines[0].index(drop)
    path = tmp_path / "metadata.csv"
    path.write_text("\n".join(",".join(c for i, c in enumerate(row) if i != col) for row in lines) + "\n",
                    encoding="utf-8")
    with pytest.raises(KeyError) as want:
        jschema.classify_columns("notice", path)
    with pytest.raises(KeyError) as got:
        tschema.classify_columns("notice", path)
    assert str(got.value) == str(want.value)


def test_missing_category_count_header_is_optional(tmp_path):
    path = tmp_path / "metadata.csv"
    path.write_text("\n".join(line.rsplit(",", 1)[0] for line in METADATA_KO.splitlines()) + "\n",
                    encoding="utf-8")
    got = tschema.classify_columns("company", path)
    assert got == jschema.classify_columns("company", path)
    assert got["categorical"] == [("region_cd", None), ("nocount_cat", None)]


def test_empty_metadata_raises_like_the_reference(tmp_path):
    path = tmp_path / "empty.csv"
    path.write_text("", encoding="utf-8")
    with pytest.raises(ValueError, match="empty metadata csv"):
        tschema.classify_columns("notice", path)
    with pytest.raises(ValueError, match="empty metadata csv"):
        jschema.classify_columns("notice", path)
