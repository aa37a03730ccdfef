"""The port's CLIs of the ETL slice, in-process through ``main(argv)``,
beside the JAX package's scripts (imported by path, as
tests/test_etl_cli.py does): ``python -m jodalrob_twotower_torch.etl``
(classify / schema / run / update-text) and ``tfrecord_tool`` (export /
count / inspect / search) print the same output and write the same files;
``integration_real`` skips all three phases offline and exits 0; the
quickstart runs (``QUICKSTART_FAST=1``) with the reference's printed
markers, and its in-memory ETL (the card machine has no pyarrow) trains
the model its parquet ETL trains."""

import gzip
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import integration_real, quickstart, tfrecord_tool
from jodalrob_twotower_torch.etl import cli as tetl
from jodalrob_twotower_torch.etl.pipeline import load_preprocessed

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import etl as jetl  # noqa: E402
import tfrecord_tool as jtfrecord_tool  # noqa: E402

METADATA_KO = """\
테이블명,컬럼명,타입,사용 여부,PK,범주형 여부,범주 갯수
notice,bidntceno,character varying(40),Y,Y,,
notice,presmptprce,numeric,Y,,,
notice,bidmethdnm,character varying(100),Y,,Y,3
notice,bidntcenm,text,Y,,,
company,bizno,character varying(10),Y,Y,,
company,empl_cnt,integer,Y,,,
company,region_cd,character(2),Y,,Y,5
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def metadata_csv(tmp_path):
    p = tmp_path / "metadata.csv"
    p.write_text(METADATA_KO, encoding="utf-8")
    return p


@pytest.fixture()
def raw_notice_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    n = 64
    price = rng.lognormal(10, 1, n)
    price[::7] = np.nan
    tbl = pa.table({
        "bidntceno": pa.array([f"N{i:04d}" for i in range(n)]),
        "presmptprce": pa.array(price),
        "bidmethdnm": pa.array(rng.choice(["open", "limited", "direct"], n)),
        "bidntcenm": pa.array([f"공사 notice {i % 9}" for i in range(n)]),
    })
    path = tmp_path / "notice_raw.parquet"
    pq.write_table(tbl, str(path))
    return path


def run(main, argv, capsys) -> tuple[int, str]:
    rc = main([str(a) for a in argv])
    return rc, capsys.readouterr().out


def both(argv_for, capsys) -> tuple[str, str]:
    """(port's stdout, reference's stdout) of one command; argv_for(side)."""
    rc_t, out_t = run(tetl.main, argv_for("torch"), capsys)
    rc_j, out_j = run(jetl.main, argv_for("jax"), capsys)
    assert rc_t == rc_j == 0
    return out_t, out_j


@pytest.mark.parametrize("table", ["notice", "company"])
def test_classify_prints_the_references_output(metadata_csv, capsys, table):
    out_t, out_j = both(lambda side: ["classify", "--table", table, "--metadata", metadata_csv], capsys)
    assert out_t == out_j
    assert json.loads(out_t)["table"] == table


@pytest.mark.parametrize("extra", [[], ["--text-embed-dim", "16"], ["--notice-text-columns", "bidntcenm"]])
def test_schema_prints_and_writes_the_references_schema(metadata_csv, tmp_path, capsys, extra):
    out_t, out_j = both(lambda side: ["schema", "--metadata", metadata_csv, *extra], capsys)
    assert out_t == out_j
    out_t, out_j = both(lambda side: ["schema", "--metadata", metadata_csv, "--out", tmp_path / f"{side}.json",
                                      *extra], capsys)
    assert out_t.replace("torch.json", "jax.json") == out_j
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()


def etl_run(metadata_csv, raw, tmp_path, capsys, chunk_rows: int = 40):
    out_t, out_j = both(lambda side: ["run", "--table", "notice", "--metadata", metadata_csv, "--input", raw,
                                      "--out-dir", tmp_path / side, "--chunk-rows", chunk_rows,
                                      "--text-embedder", "hash", "--text-embed-dim", 16], capsys)
    assert out_t == out_j
    return out_t


def assert_same_store(a: Path, b: Path) -> None:
    for f in ("notice_manifest.json", "notice_numeric.json", "notice_categorical.json"):
        assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
    got, want = load_preprocessed(a, "notice"), load_preprocessed(b, "notice")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_run_and_update_text_match_the_reference(metadata_csv, raw_notice_parquet, tmp_path, capsys):
    out = etl_run(metadata_csv, raw_notice_parquet, tmp_path, capsys)
    assert json.loads(out) == {"table": "notice", "rows": 64,
                               "chunks": ["notice_chunk_0000.parquet", "notice_chunk_0001.parquet"]}
    assert_same_store(tmp_path / "torch", tmp_path / "jax")
    texts = tmp_path / "texts.json"
    texts.write_text(json.dumps({"N0003": "totally different text", "N0063": "공사"}), encoding="utf-8")
    out_t, out_j = both(lambda side: ["update-text", "--out-dir", tmp_path / side, "--table", "notice",
                                      "--column", "bidntcenm", "--texts", texts, "--text-embedder", "hash",
                                      "--text-embed-dim", 16], capsys)
    assert out_t == out_j == "updated 2 rows of notice.bidntcenm\n"
    assert_same_store(tmp_path / "torch", tmp_path / "jax")


def test_run_errors_like_the_reference(tmp_path, capsys, raw_notice_parquet):
    meta = tmp_path / "meta_extra.csv"
    meta.write_text(METADATA_KO + "notice,absent_col,numeric,Y,,,\n", encoding="utf-8")
    messages = []
    for main in (tetl.main, jetl.main):
        with pytest.raises(SystemExit) as err:
            main(["run", "--table", "notice", "--metadata", str(meta), "--input", str(raw_notice_parquet),
                  "--out-dir", str(tmp_path / "out"), "--text-embedder", "hash"])
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "absent_col" in messages[0]
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    messages = []
    for main in (tetl.main, jetl.main):
        with pytest.raises(SystemExit) as err:
            main(["update-text", "--out-dir", str(tmp_path), "--table", "notice", "--column", "x",
                  "--texts", str(bad), "--text-embedder", "hash"])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_run_with_the_hf_embedder_needs_the_card(metadata_csv, raw_notice_parquet, tmp_path):
    for kind in ("auto", "hf"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tetl.main(["run", "--table", "notice", "--metadata", str(metadata_csv), "--input",
                       str(raw_notice_parquet), "--out-dir", str(tmp_path / kind), "--text-embedder", kind])


def test_tfrecord_tool_matches_the_reference(metadata_csv, raw_notice_parquet, tmp_path, capsys):
    etl_run(metadata_csv, raw_notice_parquet, tmp_path, capsys, chunk_rows=64)
    chunk = tmp_path / "jax" / "notice_chunk_0000.parquet"
    tools = {"torch": tfrecord_tool.main, "jax": jtfrecord_tool.main}
    outs = {}
    for side, main in tools.items():
        rec = tmp_path / f"{side}.tfrecord.gz"
        outs[side] = [run(main, ["export", "--input", chunk, "--out", rec], capsys),
                      run(main, ["export", "--input", chunk, "--out", tmp_path / f"{side}.tfrecord",
                                 "--no-compress", "--columns", "bidntceno,presmptprce,bidntcenm"], capsys),
                      run(main, ["count", rec, tmp_path / f"{side}.tfrecord"], capsys),
                      run(main, ["inspect", rec, "--limit", 2], capsys),
                      run(main, ["search", rec, "--key", "bidntceno", "--value", "N0007", "--bytes"], capsys),
                      run(main, ["search", rec, "--key", "bidmethdnm", "--value", "4", "--limit", 3], capsys)]
    assert [(rc, out.replace("torch", "jax")) for rc, out in outs["torch"]] == outs["jax"]
    assert all(rc == 0 for rc, _ in outs["torch"])
    assert outs["torch"][2][1] == "128\n"
    hits = json.loads(outs["torch"][4][1])
    assert len(hits) == 1 and hits[0]["bidntceno"] == ["N0007"]
    assert gzip.open(tmp_path / "torch.tfrecord.gz").read() == gzip.open(tmp_path / "jax.tfrecord.gz").read()
    assert (tmp_path / "torch.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()


@pytest.mark.parametrize("value, as_bytes", [("1234", False), ("1.5", False), ("abc", False), ("1234", True)])
def test_search_value_casts_like_the_reference(value, as_bytes, tmp_path, capsys):
    from jodalrob_twotower_torch.io.tfrecord import table_to_tfrecord

    rec = tmp_path / "x.tfrecord"
    table_to_tfrecord(rec, {"k": np.asarray(["1234", "abc"]), "i": np.asarray([1234, 5]),
                            "f": np.asarray([1.5, 2.0], np.float32)}, compress=False)
    argv = ["search", rec, "--key", {"1234": "i", "1.5": "f", "abc": "k"}[value], "--value", value]
    argv += ["--bytes"] if as_bytes else []
    assert run(tfrecord_tool.main, argv, capsys) == run(jtfrecord_tool.main, argv, capsys)


def test_integration_real_skips_cleanly_offline(monkeypatch, capsys):
    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.delenv("TEXT_EMBEDDING_MODEL", raising=False)
    rc = integration_real.main([])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [line["phase"] for line in lines] == ["live_pg", "real_hf_text", "default_train"]
    assert all(line["status"] == "skipped" for line in lines)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_integration_real_fails_the_hf_phase_without_a_card(monkeypatch, capsys):
    monkeypatch.delenv("DATABASE_URL", raising=False)
    monkeypatch.setenv("TEXT_EMBEDDING_MODEL", "some/model")
    rc = integration_real.main([])
    lines = {line["phase"]: line for line in map(json.loads, capsys.readouterr().out.splitlines())}
    assert rc == 1
    assert lines["real_hf_text"]["status"] == "failed" and "no CUDA device" in lines["real_hf_text"]["error"]
    assert lines["default_train"]["status"] == "skipped"


def test_quickstart_fast_prints_the_references_markers(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("QUICKSTART_FAST", "1")
    assert quickstart.main(["--force-cpu", "--workdir", str(tmp_path / "files")]) == 0
    out = capsys.readouterr().out
    assert "ETL notice:" in out and "ETL company:" in out
    assert "corpus retrieval over" in out
    assert "done" in out.splitlines()[-1]
    assert (tmp_path / "files" / "notice_manifest.json").exists()
    assert (tmp_path / "files" / "ckpt" / "final").exists()
    # without pyarrow the ETL runs in memory: the same stores, the same run
    monkeypatch.setattr(quickstart, "_has_pyarrow", lambda: False)
    assert quickstart.main(["--force-cpu", "--workdir", str(tmp_path / "memory")]) == 0
    in_memory = capsys.readouterr().out
    assert not (tmp_path / "memory" / "notice_manifest.json").exists()

    def stable(text):  # the lines that carry no path or rate
        return [line for line in text.splitlines() if line.startswith(("ETL ", "notice ", "corpus", "epoch 0: train"))]

    assert stable(in_memory) == stable(out) and len(stable(out)) == 7
