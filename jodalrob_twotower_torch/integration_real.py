"""Gated real-environment integration check (port of
``scripts/integration_real.py``): ``python -m jodalrob_twotower_torch.integration_real``.

Two capabilities the hermetic tests can only check against fakes need an
environment that may be missing:

1. live-PostgreSQL write-back: ``etl/pg_writeback.py``'s CREATE / COPY /
   UPDATE-JOIN flow against a real database (``DATABASE_URL``, and the
   ``psycopg`` driver);
2. real HF text embedding: ``etl/text.py``'s ``HFTextEmbedder`` on a real
   checkpoint (``TEXT_EMBEDDING_MODEL``, reachable or cached, and
   ``transformers``), on the card unless ``--force-cpu``.

Each phase prints one JSON line {"phase": ..., "status": "ok"|"skipped"|
"failed", ...}. Where a gate opened, a third phase trains a tiny synthetic
run on the default config. Offline all three skip and the exit code is 0; a
phase that runs and fails exits nonzero. A missing card is a failure of the
HF phase, not a skip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROWS = 100


def _emit(phase: str, status: str, **fields) -> None:
    print(json.dumps({"phase": phase, "status": status, **fields}), flush=True)


def phase_live_pg() -> bool | None:
    """Create + COPY + vector UPDATE against a real PostgreSQL, then read
    the rows back and check them against the payload the fake-backed tests
    verify. Returns None when skipped."""
    url = os.environ.get("DATABASE_URL")
    if not url:
        _emit("live_pg", "skipped", reason="DATABASE_URL not set")
        return None
    try:
        import psycopg
    except ImportError:
        _emit("live_pg", "skipped", reason="psycopg not installed")
        return None

    from jodalrob_twotower_torch.etl.pg_writeback import (
        PreprocessedUploader,
        execute_vector_update,
    )

    rng = np.random.default_rng(0)
    chunk = {
        "pk": np.asarray([f"{i:08d}" for i in range(ROWS)], object),  # leading zeros
        "score": rng.normal(size=ROWS).astype(np.float64),
        "flag": rng.integers(0, 2, ROWS).astype(bool),
        "title_emb": rng.normal(size=(ROWS, 8)).astype(np.float32),
    }
    chunk["score"][3] = float("nan")          # -> NULL scalar
    chunk["title_emb"][5, 2] = float("inf")   # -> NULL vector row
    table = "jodalrob_integration_check"

    with psycopg.connect(url) as conn:
        up = PreprocessedUploader(conn, schema="public", pk_cols=["pk"])
        n = up.upload_chunk(table, chunk)
        up.commit()
        assert n == ROWS, n

        with conn.cursor() as cur:
            cur.execute(f'SELECT count(*) FROM public."{table}"')
            assert cur.fetchone()[0] == ROWS
            cur.execute(
                f'SELECT "score", "title_emb"::text FROM public."{table}" '
                f'WHERE "pk" = %s', ("00000003",)
            )
            score, _vec = cur.fetchone()
            assert score is None, "NaN scalar must land as NULL"
            cur.execute(
                f'SELECT "title_emb" IS NULL FROM public."{table}" '
                f'WHERE "pk" = %s', ("00000005",)
            )
            assert cur.fetchone()[0], "non-finite vector row must land as NULL"
            # PK survived as text with leading zeros + real PRIMARY KEY
            cur.execute(
                "SELECT data_type FROM information_schema.columns "
                "WHERE table_name = %s AND column_name = 'pk'", (table,)
            )
            assert cur.fetchone()[0] == "text"

        # vector UPDATE round trip on 10 rows
        rows = [
            (f"{i:08d}", rng.normal(size=8).astype(np.float32)) for i in range(10)
        ]
        n_upd = execute_vector_update(
            conn, schema="public", table=table, pk_cols=["pk"],
            vec_col="title_emb", rows=rows, dims=8, ensure_column=False,
        )
        assert n_upd == 10
        with conn.cursor() as cur:
            cur.execute(f'DROP TABLE public."{table}"')
        conn.commit()
    _emit("live_pg", "ok", rows=ROWS, updated=10)
    return True


def phase_real_hf_text(device=None) -> bool | None:
    """Run a real HF checkpoint through ``HFTextEmbedder`` on ``device`` and
    check the invariants the fake-model tests assert: shapes, finiteness,
    L2 normalization, padding invariance (a text's embedding must not
    depend on what its batch was padded with) and determinism. Returns None
    when skipped: no model named, or it cannot be loaded."""
    name = os.environ.get("TEXT_EMBEDDING_MODEL")
    if not name:
        _emit("real_hf_text", "skipped",
              reason="TEXT_EMBEDDING_MODEL not set")
        return None
    from jodalrob_twotower_torch.etl.text import HFTextEmbedder, TextColumnConfig

    try:
        emb = HFTextEmbedder(model_name=name, device=device)
    except (ImportError, OSError, ValueError) as e:  # offline / no cache / no transformers
        _emit("real_hf_text", "skipped", reason=f"model load failed: {e}")
        return None

    cfg = TextColumnConfig(max_length=32, normalize=True)
    texts = [
        "조달청 공고 테스트 문장입니다",
        "두 번째 문장", "", "short", "a much longer sentence " * 8,
    ] * (ROWS // 5)
    out = emb.encode(texts, cfg)
    assert out.shape == (len(texts), emb.embed_dim), out.shape
    assert np.all(np.isfinite(out))
    norms = np.linalg.norm(out, axis=1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-3)
    # padding invariance: a short text alone vs inside a batch with long
    # texts (other pad lengths) must agree - the masked mean ignores padding
    alone = emb.encode([texts[1]], cfg)
    np.testing.assert_allclose(alone[0], out[1], atol=1e-4)
    again = emb.encode(texts[:10], cfg)
    np.testing.assert_allclose(again, out[:10], atol=1e-6)
    _emit("real_hf_text", "ok", model=name, rows=len(texts),
          embed_dim=int(emb.embed_dim), device=str(emb.device))
    return True


def phase_default_train(device=None) -> bool | None:
    """A tiny end-to-end Trainer run on a default-resolved TrainConfig, so
    that the features the opened gates produce meet the shipped defaults:
    a small synthetic set, 1 epoch, on ``device``."""
    from jodalrob_twotower_torch.config import DataConfig, TrainConfig
    from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
    from jodalrob_twotower_torch.train.trainer import Trainer

    cfg = TrainConfig(data=DataConfig(batch_size=256), results_csv="")
    ds = make_synthetic_dataset(seed=0, n_notices=2048, n_companies=2048, n_pairs=8192)
    tr, va = ds.split(0.2, seed=0)
    trainer = Trainer(cfg, ds.schema, ds.notice_store, ds.company_store, device=device,
                      log_fn=lambda s: None)
    res = trainer.train(tr, va, corpus_eval=False)
    ok = bool(np.isfinite(res.history[-1]["train_loss"]) and
              np.isfinite(res.final_val.get("loss", np.nan)))
    _emit("default_train", "ok" if ok else "failed",
          train_loss=round(res.history[-1]["train_loss"], 4),
          val_loss=round(res.final_val["loss"], 4))
    return ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Gated real-environment integration check.")
    p.add_argument("--force-cpu", action="store_true",
                   help="run the HF embedder and the training phase on the CPU instead of the card")
    args = p.parse_args(argv)
    device = "cpu" if args.force_cpu else None
    results = []
    for name, phase in (("live_pg", phase_live_pg), ("real_hf_text", lambda: phase_real_hf_text(device))):
        try:
            results.append(phase())
        except Exception as e:  # noqa: BLE001 - a phase that ran and failed is a failure
            _emit(name, "failed", error=str(e))
            results.append(False)
    if any(r is True for r in results):
        try:
            results.append(phase_default_train(device))
        except Exception as e:  # noqa: BLE001
            _emit("default_train", "failed", error=str(e))
            results.append(False)
    else:
        _emit("default_train", "skipped",
              reason="no environment gate opened (offline)")
    return 1 if any(r is False for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
