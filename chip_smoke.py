#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jodalrob_twotower_torch``) on one
NVIDIA card.

1. Builds every hand-written kernel from the checkout's sources, one nvcc
   process per source, all at once.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes its paths give it (bit-exact for the one-hot lookup, in
   its six cases, and the row gather; two calls bit-equal for the table
   gradients, the CE backward and the statistics kernels; ranks under the
   near-tie rule, also against a diagonal below every S_ii, which only a
   rank that leaves the diagonal's own column out by index gets right), and
   times kernel, plain version and the nearest library call beside the
   kernel's bound: the row gather (K4) at config 3's shape, on a bf16 table,
   a ragged batch and int64 rows past 2^31, and its zero form on a mesh
   rank's block with the block's edge ids planted (one CUDA kernel per
   masked gather, counted by the profiler); the index scan's top-k
   (``ops/chunk_topk``, which replaces no TPU kernel) bit-equal to its plain
   version on drawn shapes, then over the serving cells' 39 [256, 262,144]
   chunks at k 100 and 400 on random, ascending and tied scores, timed a
   chunk beside torch.topk and the merge, with its device tally, and in
   ``_scanned_topk`` with no torch top-k kernel on the profiler's trace;
   the int8 scan's product (``ops/int8_scan``, which replaces no TPU
   kernel) within INT8_SCAN_ULPS float32 ulps of sum |q v| x scale of its
   plain version on drawn shapes (ragged queries, rows and depths) and the
   serving cells' [256, 262,144, 128] chunks, a row scored bit for bit
   alike at any offset and query count, timed a chunk beside its bound, the
   plain version and torch.matmul of bf16-widened rows, and in
   ``Int8Index.topk_body`` over 39 chunks one launch a chunk with no GEMM
   on the profiler's trace;
   the table gradient (K2) and its [D, R] form (K3,
   equal to K2's output transposed) at the training path's two shapes, on a
   skewed batch and at R=65,536 (K2 also at each cluster size), with a
   ragged batch for agreement and a cluster launch the card refuses, which
   must raise; the CE kernels at B=8192 (K6, K11) and
   in the col-blocked range at B=16384 and 32768 (K7, K10), the statistics
   sweep at B=8192 and 1024 (K5) and 16384 and 32768 (K9) with its diagonal
   (K8); all of K5-K11 again at D=256 and 512 (the backward also at
   D=1024, its chunked branch past the wgmma one, for agreement only), and
   K8's diagonal against the sweep's S_ii bit for bit at D=128, 256 and 512;
   the backward's, the lean forward's, the statistics', the lookup's, the
   row gather's, the top-k's and the int8 scan's builds must not spill, nor the wgmma ones serialize (their
   ptxas reports
   are printed); at
   B=65536 the statistics forward against the lean forward, and the
   label-smoothed loss and its gradients finite.
3. Serving phase: drives the serving path at full width - ``TrainConfig()``
   on ``reference_shaped_schema()`` (2.19M params), random weights from a
   seeded generator, a synthetic corpus of 1,000,000 companies - through
   ``RetrievalService`` (exact in one chunk, and int8 chunked with a bf16 rescore),
   checks its answers against plain float32 scans, shows through the launch
   counters that the path ran the kernels, and measures throughput; then the
   serve CLI's auto-configuration (``calibrate_serving_config`` at recall
   0.95, k=100, 2,048 notice queries) over the 1M corpus embeddings, from the
   card and streamed from host numpy: the same pick, the two exact
   references equal except at ties, both timed.
4. Training phase: the headline bench's workload (``jodalrob_twotower_torch.
   bench``: the same config at B=8192, 16 steps per call, stores and pairs
   on the card) for one warm-up and several timed calls; the launch counters
   show that the steps ran the lookup, table-gradient and CE kernels; every
   loss must be finite and the last call's mean below the first's.
5. Evaluation phase, on the trained state: ``Evaluator.evaluate_indexed``
   over held-out pairs at B=8192 (K5 and K8) and at B=16384 (K8 and K9),
   one batch's fused metrics against ``in_batch_metrics`` of the same
   embeddings, then ``corpus_retrieval_eval`` of the held-out notices
   against the 100,000 companies; in-batch recall@10 and corpus recall@100
   must beat their random baselines.
6. Extra training paths: one call of the sampled train steps at B=16384 (the
   col-blocked CE, K7 and K10) and one at B=8192 with label smoothing 0.1
   (the statistics forward K8 + K5, and K11); every loss finite.
7. Headline phase: the trainer's path end to end, ``train_headline.main``
   (the port's training CLI in-process: ``TrainConfig()`` on the
   bench-scale data, B=8192, 8 epochs sampled on the card, validation and
   the corpus eval after every epoch, checkpoints, metrics and the results
   CSV, all in a temporary directory); every epoch's losses finite, the run
   learned, its final corpus recall@100 within 0.05 of the JAX artifact's,
   and every kernel launched exactly as often as the run's steps,
   validation batches and encode chunks ask.
8. Serve-CLI phase, on the headline's trained weights:
   ``python -m jodalrob_twotower_torch.serve`` in-process over the 100,000
   companies, 8,192 notices at k=100 per run: int8 built and saved, then
   loaded (the JSONL equal line for line), exact (the int8 and exact answers
   each equal to a plain scan of the same embeddings except at ties; the
   int8 recall@100 against exact measured), ``--target-recall 0.95`` (the
   pick's measured recall meets it) and ``--qps-bench``; K1 launched exactly once per corpus encode chunk
   and query batch, the top-k twice and the int8 product once a block the
   int8 index searched, no other kernel.
9. Resume phase: 8 sampled steps with dropout at B=8192, ``save_step``, a
   restore into a freshly built state and 8 more steps equal 16
   uninterrupted steps bit for bit (every param, moment and BatchNorm
   statistic); the checkpoint restores onto the CPU and back bit for bit;
   ``restore_weights`` -> ``RetrievalService`` searches as the in-memory
   weights do.
10. Profile phase: ``python -m jodalrob_twotower_torch.profile_step``'s
   variants at B=8192 over the bench's stores (one warm-up and 3 timed
   dispatches of 16 steps each): ms/step finite and each kernel's launches
   exact per step (the variants that bypass K1, K2 or K6/K11 launch them
   never); its trace of 3 dispatches of ``full``, busy share in (0, 1]; the
   measured matmul peak.
11. Host-fed phase, on the bench's data at B=8192: ``index_stacks`` windows
   of 16 steps, 2 in flight, through ``make_scanned_train_steps`` for 160
   steps, timed between two runs of the device-sampled bench's calls and
   beside the same steps on windows uploaded beforehand;
   ``train_batches`` (``BackgroundAssembler`` gathering each batch into
   page-locked memory on a worker thread, ``prefetch_to_device`` copying it
   on a side stream) through ``make_train_step`` for 24 batches, with the
   MB per step, the effective host-to-device rate and the consumer's wait
   for each batch, beside the gather on the consumer's thread and beside
   the same batches already on the card, then the race check: 8 batches through that path and the
   same 8 through plain blocking copies, from copies of one state, equal
   bit for bit (losses and every parameter, moment and statistic);
   ``Trainer.train`` fed by ``streaming_index_batches`` over the training
   pairs in 4 in-memory chunks (``train_streaming``'s source without the
   parquet reader) for 2 epochs with validation: every epoch runs the
   batches its stream yields, losses finite and falling. K1, K2, K6 and
   K11 launch exactly as the steps ask, K1, K6, K8 and K5 as the validation
   batches ask.
12. ETL phase: raw tables to a trained, serving model at the bench's width
   (``etl_phase``): a reference-format metadata.csv classified and turned
   into a schema with the port's functions; 100,000 notices and companies
   (29 numeric, 32 categorical of 990 values and the title; 1 numeric and 6
   categorical) and 400,000 pairs in 256 planted clusters, from seed; the
   ETL that ``run_pipeline`` composes, in memory (the fit on the whole
   table, the transform in chunks of 25,000, the hash embedder at 768;
   only the parquet files are left out, the card machine has no pyarrow)
   into the manifest's schema and the feature stores, the unified notice
   table [32768, 32]; ``Trainer.train`` at B=8192 for 2 epochs with
   validation and the corpus eval (launches exact, loss falling, corpus
   recall@100 >= 0.01); the int8 service over the 100,000 companies
   answering 8,192 held-out notices (equal to a plain int8 scan except at
   ties); the company table and 2,000 notices to gzip TFRecord and back
   with the native CRC32C, and 20,000 company rows through the Example
   encoder's direct and general paths (the same bytes, both rates); and
   ``quickstart.main`` at its full size
   (launches exact: K2 only, its float32 towers at D = 32).
13. The large-table paths, BASELINE config 3 (tables of 10,000,384 x 64 f32
   per tower, B=8192): ``scaled_dense`` (the row-gather kernel K4 through
   ``MeshConfig.use_pallas_lookup``, the full-table scatter and rowwise
   Adagrad), ``scaled_sparse`` (sparse tables, one update per step) and
   ``scaled_sparse_deferred`` (one update per 8-step window), each one
   warm-up and three timed calls of 8 steps; the launch counters show K4
   twice per step on the dense path and never on the sparse ones, K1 and
   K2 never, K6 and K11 once per step; then two sparse steps against two
   dense steps from one state.
14. One step's loss and gradients at B=1024 on the card against the same step
   on the CPU through the plain versions.
15. The mesh phase (``mesh_phase``): two ranks over gloo share the card (NCCL
   refuses two ranks on one device), spawned by the port's launcher after
   the kernels are built, each with the bench's data: ``Trainer(mesh=...)``
   for one sampled epoch at B=8192 with validation and the sharded corpus
   eval (equal to one device's eval of the same embeddings), one mesh step
   against one device's step on the whole batch, two steps at B=16384 and
   two with label smoothing 0.1 (the ranks' states bit-equal after every
   step), and ``ShardedIndex`` over 1M companies, exact and int8, against
   one device's index; launches exact per rank. On the same ranks the
   compressed gradient sync (``mesh_compressed``): each wire format's first
   loss bit-equal, local and global negatives; on one step's gradients the
   int16 total bit-equal to an f64 sum of the gathered quanta times the
   scale, the residuals within half a quantum (int16) and half a bf16 ulp;
   "global" under "none" against the uncompressed mesh step; the Trainer
   for one sampled epoch under int16 and bf16 (the ranks bit-equal after
   every call) and the "none" control on the same draws, each loss falling,
   int16's and bf16's within 5% of "none"'s; one timed call a method and
   negatives; launches exact per rank, the wire bytes from the buffers.
   Then the train, eval and
   serve CLIs in-process with ``--mesh-devices 1`` (one NCCL rank) beside
   the same runs without it: bit-equal; and the training CLI with
   ``--store-sharding rows`` too, bit-equal, its checkpoint restored on one
   device.
16. The large-table mesh (``mesh_rows_phase``): BASELINE config 3 over two
   gloo ranks on the card, tables ("auto" -> "gspmd_rows") and stores
   row-sharded, 5,000,192 table rows a rank: ``mesh_scaled_dense`` (K4 on
   each rank's block), ``mesh_scaled_sparse``, ``mesh_scaled_sparse_deferred``
   and ``mesh_scaled_sparse_sampled``. Each path's two steps from one state
   against one device's on the same batches (taken one rank at a time
   before the mesh's, each rank keeping its block), the ranks' replicated
   leaves bit-equal, rows no batch touched bit-equal to their start, then
   three timed calls of 8 steps; launches exact per rank and step, peak
   memory per rank, and the seconds to gather a checkpoint's row-sharded
   leaves to rank 0. ``mesh_scaled_sparse_int16``: the sparse path under
   the int16 sync with global negatives and no BatchNorm, stores
   replicated; its first loss and the table blocks after it against one
   device's, then the same checks and timed calls. The kernel phase holds K4's zero form on a rank's
   block (ids over the whole table, rows outside the block zero) bit-exact.
17. A model axis above 1 (``mesh_model_phase``): four gloo ranks on the card
   as a (2, 2) (data, model) mesh, ``TrainConfig()`` on the bench's data at
   global B=8192 (4,096 rows a data index): two sampled steps and one eval
   batch, and the same on ranks 0 and 1 as a (2, 1) mesh from the same
   state. The losses, eval metrics and state digests of the two ranks of
   each data index bit-equal to each other and to the (2, 1) rank of that
   index; launches exact on every rank.
18. ``python -m jodalrob_twotower_torch.multihost_smoke`` (two processes,
   the streaming leg fed from memory): every check of the reference's.
19. The mesh scripts on two gloo ranks: ``sharded_serving_bench`` (200,000
   x 128, recall equal to one device's but at ties), ``rowsharded_store_bench``
   (the reference's 1,266.5 MiB store, "rows" against "replicated": the
   losses bit-equal, half the rows a rank) and ``scaling_sweep`` (1 and 2
   ranks at B=4096; the mesh of one's launches exact).
20. The one-device studies: ``onehot_rowsharded_study`` (K1 at three
   shapes), ``embgrad_microbench`` (K2 against K3, K3's first path),
   ``topk_microbench`` (with the scan's top-k kernel) and
   ``scatter_microbench`` (plain PyTorch); each kernel launched exactly as
   the scripts' timings ask.
21. ``python -m jodalrob_twotower_torch.reference_scale_demo`` at its
   defaults (BASELINE config 2's migration at B=256) on a metadata
   directory written here in the reference's format: the reference's
   schema, launches exact, the metrics finite and above random. Each of
   phases 17-21 prints its seconds.

Run from the repository root: ``python3 chip_smoke.py``. Any failure exits
nonzero; so does a machine without a CUDA device. The second-to-last line is
the per-kernel JSON record, the last line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gzip
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import gen_kanana
from jodalrob_twotower_torch import bench, profile_step, quickstart, serve, train, train_headline
from jodalrob_twotower_torch import (
    embgrad_microbench,
    multihost_smoke,
    onehot_rowsharded_study,
    reference_scale_demo,
    rowsharded_store_bench,
    scaling_sweep,
    scatter_microbench,
    sharded_serving_bench,
    topk_microbench,
)
from jodalrob_twotower_torch import eval as eval_cli
from jodalrob_twotower_torch.etl.pipeline import preprocess_in_memory
from jodalrob_twotower_torch.etl.text import HashTextEmbedder
from jodalrob_twotower_torch.etl.to_feature_store import feature_store_from_columns, side_schema_from_manifest_dict
from jodalrob_twotower_torch.io import crc32c as crc32c_io
from jodalrob_twotower_torch.io.tfrecord import (
    TFRecordReader,
    TFRecordWriter,
    count_records,
    search_records,
    table_to_tfrecord,
)
from jodalrob_twotower_torch.config import LossConfig, MeshConfig, ModelConfig, OptimizerConfig, TrainConfig
from jodalrob_twotower_torch.data.parquet_stream import streaming_index_batches
from jodalrob_twotower_torch.data.pipeline import index_stacks, train_batches
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch, default_tower_gather
from jodalrob_twotower_torch.evaluation.evaluator import (
    Evaluator,
    corpus_retrieval_eval,
    demonstrate_predictions,
    qualitative_assessment,
    sharded_corpus_retrieval_eval,
)
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.models import text_encoder as text_encoder_mod
from jodalrob_twotower_torch.models.text_encoder import rope_tables
from jodalrob_twotower_torch.ops import _build
from jodalrob_twotower_torch.ops import chunk_topk as ct
from jodalrob_twotower_torch.ops import embedding_grad as eg
from jodalrob_twotower_torch.ops import fused_logits as fl
from jodalrob_twotower_torch.ops import int8_scan as i8
from jodalrob_twotower_torch.ops import moe
from jodalrob_twotower_torch.ops.embedding_grad import (
    TILE_ROWS,
    dense_table_grad_bmajor_plain,
    dense_table_grad_plain,
    dense_table_lookup_plain,
    table_grad_launch_shape,
)
from jodalrob_twotower_torch.ops import embedding_lookup as el
from jodalrob_twotower_torch.ops.embedding_lookup import embedding_lookup_pallas_plain
from jodalrob_twotower_torch.ops.fused_logits import (
    _bwd_constants,
    fused_ce_bwd_plain,
    fused_lean_lse_plain,
    fused_stats_sweep_plain,
    same_tile_diag_plain,
)
from jodalrob_twotower_torch.schema import (
    CategoricalSpec,
    EncodedTextSpec,
    NumericSpec,
    SideSchema,
    TwoTowerSchema,
    classify_columns,
    reference_shaped_schema,
    schema_from_metadata_csv,
    tiny_synthetic_schema,
)
from jodalrob_twotower_torch.serving import autoconfig
from jodalrob_twotower_torch.parallel import compressed_grads
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_torch.parallel.mesh import make_mesh, put_replicated, shard_state
from jodalrob_twotower_torch.parallel.sharded_embedding import local_rows, masked_shard_gather
from jodalrob_twotower_torch.parallel.sharded_sparse import make_sharded_sampled_sparse, make_sharded_sparse_train
from jodalrob_twotower_torch.parallel.sharded_store import resolve_store_placement
from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_indexed_train
from jodalrob_twotower_torch.serving.index import (BruteForceIndex, Int8Index, ShardedIndex, _merge_topk,
                                                   _scanned_topk, quantize_int8, recall_vs_exact)
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService, qps_bench
from jodalrob_twotower_torch.train.metrics import diagonal_ranks, in_batch_metrics, random_baselines
from jodalrob_twotower_torch.train import sparse_tables
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager, state_payload
from jodalrob_twotower_torch.train.train_step import (
    create_train_state,
    device_store,
    loss_and_grads,
    make_encode_fn,
    make_indexed_eval_steps,
    make_sampled_train_steps,
    make_sharded_ce,
    make_scanned_train_steps,
    SAMPLE_STREAM,
    step_generator,
    make_train_step,
    resolve_store_dtype,
)
from jodalrob_twotower_torch.train.cli import split_pairs
from jodalrob_twotower_torch.train.optimizer import build_optimizer
from jodalrob_twotower_torch.train.trainer import Trainer, host_store
from jodalrob_twotower_torch.utils.flops import H100_PEAK_BF16_FLOPS
from jodalrob_twotower_torch.utils.profiling import (device_breakdown, device_flops_estimate, kernel_launches, median_ms,
                                                     reset_kernel_launches)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet), at the 700 W limit
# the special-function units' exponentials: 16 per clock and SM (CUDA C++
# Programming Guide, arithmetic throughput, compute capability 9.0), 132 SMs
# at the 1.98 GHz boost clock (H100 SXM data sheet)
H100_EXP_PER_S = 132 * 16 * 1.98e9
KERNEL_SOURCES = ["onehot_lookup", "table_grad", "fused_ce_fwd", "fused_ce_bwd", "fused_stats", "row_gather",
                  "chunk_topk", "moe_dispatch", "int8_scan"]  # csrc/<name>.cu
TIMED_RUNS = 100
LARGE_TIMED_RUNS = 20  # B >= 16384, where the plain versions take tens of ms
CE_BATCH, CE_DIM = 8192, 128  # the training path's loss shape
TRAIN_TIMED_CALLS = 10
GRAD_CHECK_BATCH = 1024
# stated tolerances, kernel against plain version on the card
LSE_ATOL = 1e-4  # lse of 8192 terms: f32 sums in another order, ex2.approx (a few ulp)
# the shifted forward at tau = 0.01, |S| up to 100, where the unshifted sums
# overflow f32: S itself carries the f32 rounding of 128 products summed in
# another order, a few ulps of |S| (7.6e-6 an ulp at 100), and lse follows
# its largest terms, so the tolerance is LSE_ATOL plus LSE_RTOL_LARGE of |lse|
LARGE_LOGIT_TAU = 0.01
LSE_RTOL_LARGE = 1e-6
CE_BWD_RTOL = 1e-3  # of max |plain|: A is rounded to bf16, an entry on a boundary may round apart
GRAD_ATOL = 1e-4  # f32 sums of <= a few hundred bf16 values of g ~ N(0, 1), another order
GRAD_CLUSTERS = (1, 2, 4, 8)  # the table gradient's cluster sizes (CTAs per tile), each checked and timed
REFUSED_CLUSTER = 32  # past the card's largest cluster (16): the launch must be refused, and raise
GRAD_ENVELOPE_FEATURES = 64  # x 1,024 rows = DENSE_GRAD_MAX_ROWS, the dense table gradient's envelope edge
# one step, card against CPU: the loss within 2e-3 (bf16 activations); each
# gradient leaf within 1.5 times its own bf16 noise (the CPU's bf16 gradient
# against a float32 one) plus 0.005 (relative norms)
STEP_GRAD_NOISE_FACTOR = 1.5
STEP_GRAD_SLACK = 0.005
STEP_LOSS_ATOL = 2e-3
# the statistics kernels against their plain versions on the same bf16
# operands (only the order of the f32 sums differs): lse 1e-4 absolute (as
# K6), the diagonal 1e-5 absolute (a sum of 128 exact products), the row and
# column sums 1e-3 of their largest magnitude (sums of B terms that cancel);
# ranks may differ only where S_ij lies within NEAR_TIE_ATOL of the diagonal
# in the plain S, on at most RANK_ROW_SHARE of the rows (the TPU selftest's
# rule, scripts/tpu_selftest.py:56-77, with its lse/sum gates tightened since
# the plain version here takes bf16 operands too)
STATS_LSE_ATOL = 1e-4
DIAG_ATOL = 1e-5
STATS_SUM_RTOL = 1e-3
NEAR_TIE_ATOL = 1e-5
RANK_ROW_SHARE = 1e-3
STATS_TAU = 0.3  # the TPU selftest's temperature for the statistics checks
BLOCKED_BATCHES = (16384, 32768)  # the col-blocked range's cases (K7-K10)
WIDE_DIMS = (256, 512)  # embedding widths past the first 128-deep chunk (K5-K11)
CHUNKED_CE_DIM = 1024  # a width past the CE kernels' wgmma branches (D <= 512)
WIDE_TIMED_RUNS = 20
LARGEST_BATCH = 65536  # the envelope's top: stats against lean forward, loss and grads finite
EVAL_PAIRS = 32768  # held-out pairs: 4 eval batches at 8192, 2 at 16384
EVAL_TIMED_CALLS = 10  # evaluate_indexed calls per path; ms per batch is their median
EVAL_SIM_ATOL = 1e-4  # fused eval similarities against in_batch_metrics
EXTRA_STEPS = 2  # steps per call of the extra training paths
HEADLINE_EPOCHS = 8  # the headline recipe's epochs (scripts/train_headline.py), not cut
RESUME_STEPS = 8  # steps before the step checkpoint, and after the restore (the trainer's n_inner)
RESUME_QUERIES = 1024  # notices searched with the restored and the in-memory weights
# BASELINE config 3, the large-table path (bench_suite.py:80-105): 8
# categorical features of 1.25M ids per tower (unified tables of 10,000,384 x
# 64 f32, 2.56 GB each), 16 numeric features, hidden (512, 256), final 128
SCALED_VOCAB, SCALED_FEATURES, SCALED_NUMERIC, SCALED_DIM = 1_250_000, 8, 16, 64
# its data (bench_suite.py:97-105): 200,000 notices and companies, 16,384
# pairs, 64 clusters, ids uniform over each vocab; B=8192 sampled on the card
SCALED_NOTICES = 200_000
SCALED_PAIRS = 16_384
SCALED_CLUSTERS = 64
SCALED_BATCH = 8192
SCALED_CALL_STEPS = 8  # steps per call; the deferred path's window
SCALED_TIMED_CALLS = 3
SCALED_CHECK_STEPS = 2
# sparse against dense on the card, from one state (dropout 0), after two
# steps: each entry's change of the tables and accumulators agrees within
# 1e-3 of the largest change plus two float32 ulps of the entry (both paths
# sum the same f32 cotangents of a row's duplicates, in another order, and
# index_add_ on CUDA sums them in no fixed order, so a row may round to a
# neighbouring float); dense params within one Adam step of either sign
# (2 lr) per entry, and within 1e-6 on all but 1% of the entries (a
# gradient near zero may round to either sign). The check's accumulators
# start at 0 with eps 1e-16: at the default 0.1 a step's mean(G^2) at
# B=8192 lies below half an ulp of 0.1, no accumulator would move, and
# summing duplicates or not would give the same step.
SCALED_CHANGE_RTOL = 1e-3
SCALED_VALUE_ULPS = 2.0 ** -22
SCALED_DENSE_SLACK_SHARE = 0.01
SCALED_CHECK_ADAGRAD = {"adagrad_init_accumulator": 0.0, "adagrad_eps": 1e-16}
CALIBRATION_TARGET = 0.95  # the serve CLI's --target-recall in the serving and serve-CLI phases
CALIBRATION_QUERIES = 2048  # the serve CLI's sample (serve.CALIBRATION_QUERIES)
STREAM_CHUNK = 262_144  # corpus rows per streamed slice of the exact reference (the calibration's default)
SERVE_QUERIES = 8192  # notices the serve CLI answers in each run, in batches of serve.QUERY_BATCH
SERVE_QPS_BATCHES = 11  # qps_bench's warm-up batch and its 10 timed ones (serve.main)
PROFILE_VARIANTS = {  # per-step launches of K1, K2, K6, K11 on each profile_step variant the smoke times
    "full": (2, 2, 1, 1), "no_opt": (2, 2, 1, 1), "fwd_only": (2, 0, 1, 0), "gather_only": (0, 0, 0, 0),
    "sample_only": (0, 0, 0, 0), "xla_loss": (2, 2, 0, 0), "scatter_grad": (0, 0, 1, 1),
    "gather_lookup": (0, 2, 1, 1),
}
PROFILE_DISPATCHES = 3  # timed dispatches of 16 steps per variant (the CLI's default is 20)
HOSTFED_N_INNER = 16  # steps per index window (bench_suite.py train_hostfed)
HOSTFED_STEPS = 160  # host-fed index steps timed (bench_suite.py train_hostfed)
HOSTFED_FEATURE_BATCHES = 24  # host-assembled feature batches timed (bench_suite.py train_hostfed_features)
HOSTFED_PREFETCH = 2  # batches or windows in flight on the card
RACE_CHECK_BATCHES = 8  # batches through the prefetched and the plain feed, from one state
STREAM_CHUNKS = 4  # in-memory chunks the streaming trainer's source reads
STREAM_EPOCHS = 2
# the mesh phase: two ranks on the one card over gloo (NCCL refuses two ranks
# on one device), the trainer for one epoch in dispatches of 16 steps, two
# steps at B=16384 and at label smoothing 0.1, each rank's loss and grads
# against one device's within MESH_LOSS_RTOL and the step check's gate
MESH_RANKS = 2
MESH_EPOCHS = 1
MESH_N_INNER = 16
MESH_EXTRA_STEPS = 2
MESH_LOSS_RTOL = 1e-5
MESH_PG_S = 300  # each rank's process-group timeout
MESH_JOIN_S = 600  # the launch's deadline: past it the ranks are killed
# the compressed gradient sync on the same ranks (``mesh_compressed``): each
# wire format's first loss, its sum and residual, "global" against the
# uncompressed mesh step, the Trainer for one sampled epoch a method, and
# ms/step a rank from one timed call of COMPRESSED_TIMED_STEPS steps
COMPRESSED_METHODS = ("none", "int16", "bf16")
COMPRESSED_NEGATIVES = ("local", "global")
COMPRESSED_TIMED_STEPS = 16
COMPRESSED_LEARN_REL = 0.05  # tests/test_compressed_grads.py's rel: int16 and bf16 final losses against "none"
COMPRESSED_WIRE_RANKS = (2, 4, 8)  # the wire bytes a rank sends per step, from the buffers, at each mesh size
# the serving cells' scan (benchmark/traffic/*_b256_k100*.json): 256 notices
# against 10,000,000 companies in 39 chunks of 262,144 rows, k 100 (exact)
# and 400 (int8, the rescore depth)
TOPK_QUERIES, TOPK_ROWS, TOPK_CHUNKS, TOPK_VALID = 256, 262_144, 39, 10_000_000
TOPK_KS = (100, 400)
TOPK_TIMED_RUNS = 10  # timed scans of 39 chunks (the plain version's: 3)
# the int8 scan's product against its plain version: both sum the same exact
# float32 products in another order, so they may differ by a few float32
# ulps of the score's own scale, sum |q v| x scale
INT8_SCAN_ULPS = 8
# torch's top-k kernels, by name (benchmark/metrics/topk_share.py's pattern)
TORCH_TOPK_KERNELS = re.compile(r"at::native::mbtopk::|at::native::sbtopk::|at::native::radixSortKVInPlace<")
N_COMPANIES = 1_000_000
N_NOTICES = 20_000
QUERY_BATCH = 1024
TOP_K = 100
SEED = 0


def ptxas_report(log: str) -> list[dict]:
    """Per kernel function of one library's build log (``nvcc -Xptxas -v``):
    its registers a thread at launch, static shared memory, spill bytes,
    and whether ptxas serialized its wgmma (warnings C7510-C7515)."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = {"function": m.group(1), "wgmma_serialized": any(
                "wgmma.mma_async instructions are serialized" in w and m.group(1) in w for w in log.splitlines())}
            out.append(fn)
        elif fn is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            fn["spill_store_bytes"], fn["spill_load_bytes"] = int(m[1]), int(m[2])
        elif fn is not None and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            fn["registers"], fn["static_smem_bytes"] = int(m[1]), int(smem[1]) if smem else 0
    return out


def build_report(name: str, dynamic_smem_bytes: dict | None = None) -> dict:
    """One library's ptxas report (and its kernels' dynamic shared memory
    per width, where given), printed; fails on a spill or on serialized
    wgmma."""
    build = {"functions": ptxas_report(_build.build_log(name))}
    if dynamic_smem_bytes is not None:
        build["dynamic_smem_bytes"] = dynamic_smem_bytes
    print(f"ptxas {name} " + json.dumps(build), flush=True)
    check(bool(build["functions"]), f"{name}: no ptxas report in its build log")
    check(all(f.get("spill_store_bytes", 0) == 0 == f.get("spill_load_bytes", 0) for f in build["functions"]),
          f"{name} spills: {build['functions']}")
    check(not any(f["wgmma_serialized"] for f in build["functions"]),
          f"{name}: ptxas serialized wgmma: {build['functions']}")
    return build


def fwd_build_report() -> dict:
    """The lean forward's ptxas report and shared memory per width."""
    return build_report("fused_ce_fwd", {f"{d} {form}": fl._fwd_lib().fused_lean_lse_smem_bytes(d, form == "nomax")
                                         for d in (128, 256, 384, 512) for form in ("nomax", "shifted")})


def stats_build_report() -> dict:
    """The statistics kernels' ptxas report and the sweep's shared memory per width."""
    return build_report("fused_stats", {d: fl._stats_lib().fused_stats_smem_bytes(d) for d in (128, 256, 384, 512)})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


# -- kernel phase --------------------------------------------------------------


def lookup_case(name: str, vocabs: tuple[int, ...], batch: int, table_dtype, gen, *, ragged: bool, d: int = 32):
    """Inputs of the one-hot lookup at one of its paths' shapes (embed width d)."""
    offsets, total_rows = table_layout(vocabs)
    # ragged: ids also reach the block's alignment padding (in block, served)
    ids = np.stack([gen.integers(0, -(-v // 128) * 128 if ragged else v, size=batch) for v in vocabs], axis=1)
    rows = ids + offsets[None, :]
    if ragged:  # rows of other features' blocks, -1 padding, rows past the table
        k = len(vocabs)
        other = gen.random(rows.shape) < 0.1
        rows[other] = rows[other] + offsets[1] * gen.integers(1, k, size=int(other.sum()))
        rows[other] %= total_rows
        rows[gen.random(rows.shape) < 0.05] = -1
        rows[gen.random(rows.shape) < 0.01] = total_rows + 3
    table = torch.from_numpy(gen.normal(size=(total_rows, d)).astype(np.float32))
    return {
        "case": name,
        "table": table.to("cuda", table_dtype),
        "rows": torch.from_numpy(rows.astype(np.int32)).to("cuda"),
        "tile_feature": torch.from_numpy(tile_feature_map(vocabs)).to("cuda"),
    }


def lookup_bytes(table, rows, tile_feature) -> int:
    """Least bytes the lookup must move: ids and tile map read, each
    referenced in-block table row read once, the bf16 output written."""
    b, k = rows.shape
    r, d = table.shape
    safe = rows.clamp(0, r - 1).long()
    in_block = (rows >= 0) & (rows < r) & (tile_feature[safe // 128] == torch.arange(k, device=rows.device))
    unique_rows = int(torch.unique(safe[in_block]).numel())
    return rows.numel() * 4 + tile_feature.numel() * 4 + unique_rows * d * table.element_size() + b * k * d * 2


def lookup_phase(flush: torch.Tensor | None, runs: int = TIMED_RUNS) -> dict:
    """K1 bit-exact against its plain version at each of its paths' shapes,
    timed (``runs`` launches) beside its bound and ``F.embedding``; the
    kernel is reached through the module, so a fault planted there
    (planted_faults.py) shows here."""
    gen = np.random.default_rng(SEED)
    schema = reference_shaped_schema()
    cases = [  # the training path's shapes first (its record reports the first), then serving's
        lookup_case("notice B=8192 K=32 R=32768", schema.notice.vocab_sizes, 8192, torch.float32, gen, ragged=False),
        lookup_case("notice B=1024 K=32 R=32768", schema.notice.vocab_sizes, 1024, torch.float32, gen, ragged=False),
        lookup_case("company B=8192 K=6 R=6144", schema.company.vocab_sizes, 8192, torch.float32, gen, ragged=False),
        lookup_case("ragged B=1000 K=32 R=32768", schema.notice.vocab_sizes, 1000, torch.float32, gen, ragged=True),
        lookup_case("ragged bf16 table B=1000 K=32", schema.notice.vocab_sizes, 1000, torch.bfloat16, gen, ragged=True),
        # D=24: three 16-byte pieces a row, so a warp's pieces are not a multiple of 32
        lookup_case("ragged D=24 B=1000 K=32", schema.notice.vocab_sizes, 1000, torch.float32, gen, ragged=True, d=24),
        # D=8: one 16-byte piece a row (the multihost smoke's compressed Trainer)
        lookup_case("ragged D=8 B=1000 K=32", schema.notice.vocab_sizes, 1000, torch.float32, gen, ragged=True, d=8),
    ]
    results = []
    for c in cases:
        args = (c["table"], c["rows"], c["tile_feature"])
        got = eg.dense_table_lookup(*args)
        want = dense_table_lookup_plain(*args)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        row = {"case": c["case"], "equal": equal, "max_abs_err": err, **bound(0, lookup_bytes(*args))}
        if runs:
            rows_long = c["rows"].clamp(0, c["table"].shape[0] - 1).long()  # F.embedding takes no -1
            timed(row, lambda: eg.dense_table_lookup(*args), lambda: dense_table_lookup_plain(*args),
                  lambda: torch.nn.functional.embedding(rows_long, c["table"]).to(torch.bfloat16), flush, runs)
        print("kernel onehot_lookup", json.dumps(row), flush=True)
        check(equal, f"onehot_lookup != plain version, case {c['case']} (max abs err {err})")
        results.append(row)
    return {"onehot_lookup": results}


def unit_rows(gen: torch.Generator, b: int, d: int, device) -> torch.Tensor:
    x = torch.randn(b, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def ce_inputs(b: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Tower-like embeddings: unit rows, each positive near its row
    (tau = 1, the default, so N/tau = N and |S| <= 1)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = unit_rows(gen, b, d, device)
    c = n + 0.8 * unit_rows(gen, b, d, device)
    return n, c / c.norm(dim=1, keepdim=True)


def timed(row: dict, fn, plain, library, flush, runs: int = TIMED_RUNS) -> dict:
    row["ms"] = median_ms(fn, flush, runs)
    row["plain_ms"] = median_ms(plain, flush, runs)
    row["library_ms"] = median_ms(library, flush, runs)
    return row


def bound(flops: float, nbytes: float, exps: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate (bf16 tensor-core
    products; exponentials on the special-function units)."""
    ops_s = max(flops / H100_PEAK_BF16_FLOPS, exps / H100_EXP_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "operations" if ops_s > bytes_s else "bytes"}


def lean_case(flush: torch.Tensor, b: int, nomax: bool, runs: int = 0, label: str = "fused_ce_fwd",
              d: int = CE_DIM, tau: float = 1.0, rows: int = 0) -> dict:
    """The lean forward (K6; K7 past B=8192) at batch b and width d, on N/tau,
    against its plain version, two calls bit-equal; timed beside its bound
    and a library yardstick when ``runs``. With ``rows`` the last ``rows``
    rows of N against all of C: a mesh rank's block (the forward needs no
    row offset)."""
    n, c = ce_inputs(b, d, "cuda")
    n = n[b - rows:] / tau if rows else n / tau
    m = n.shape[0]
    # through the module, so a fault planted there (planted_faults.py) shows here
    got, again = fl.fused_lean_lse(n, c, nomax=nomax), fl.fused_lean_lse(n, c, nomax=nomax)
    want = fused_lean_lse_plain(n, c, nomax=nomax)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tol = LSE_ATOL + (LSE_RTOL_LARGE * max(float(w.abs().max()) for w in want) if tau != 1.0 else 0.0)
    row = {"case": (f"rows {b - m}..{b} of " if rows else "") + f"B={b} D={d} {'nomax' if nomax else 'shifted'}"
           + (f" tau={tau}" if tau != 1.0 else ""),
           "two_calls_equal": all(torch.equal(x, y) for x, y in zip(got, again)), "max_abs_err": err,
           "tolerance": tol}
    if runs:
        nb, cb = n.to(torch.bfloat16), c.to(torch.bfloat16)
        # products 2 m B D; one exponential per entry unshifted, two shifted (row and column max)
        row.update(bound(2 * m * b * d, (m + b) * d * 2 + (m + b) * 4, exps=(1 if nomax else 2) * m * b))

        def library():
            s = (nb @ cb.T).float()
            return torch.logsumexp(s, 1), torch.logsumexp(s, 0)

        timed(row, lambda: fl.fused_lean_lse(n, c, nomax=nomax), lambda: fused_lean_lse_plain(n, c, nomax=nomax),
              library, flush, runs)
    print(f"kernel {label}", json.dumps(row), flush=True)
    check(row["two_calls_equal"], f"{label} ({row['case']}): two calls differ")
    check(err <= tol, f"{label} ({row['case']}) vs plain: max abs err {err} > {tol}")
    return row


def bwd_case(flush: torch.Tensor, b: int, eps: float = 0.0, runs: int = 0, shard: bool = False,
             label: str = "fused_ce_bwd", d: int = CE_DIM) -> dict:
    """The backward (K11; K10 past B=8192) at batch b and width d against
    its plain version, two calls bit-equal; with ``shard`` the second half of
    N as a row shard against all of C (the diagonal at column row +
    offset)."""
    n, c = ce_inputs(b, d, "cuda")
    rl, cl = fused_lean_lse_plain(n, c, nomax=True)
    args = (n, c, rl, cl, eps, 0)
    case = f"B={b} D={d}" + (f" eps={eps}" if eps else "")
    if shard:
        half = b // 2
        args = (n[half:], c, rl[half:], cl, eps, half)
        case = f"rows {half}..{b} of B={b}, row_offset={half}"
    # through the module, so a fault planted there (planted_faults.py) shows here
    got, again, want = fl.fused_ce_bwd(*args), fl.fused_ce_bwd(*args), fused_ce_bwd_plain(*args)
    torch.cuda.synchronize()
    rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    row = {"case": case, "two_calls_equal": all(torch.equal(x, y) for x, y in zip(got, again)),
           "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "max_rel_err": rel, "tolerance_rel": CE_BWD_RTOL}
    if runs:
        nb, cb, rl_m, off = args[0].to(torch.bfloat16), c.to(torch.bfloat16), args[2], args[5]
        m = nb.shape[0]
        # the function's work: products 6 m B D (S, A C, A^T N); two exponentials
        # per entry (its row- and column-softmax terms), though the kernel's dn and
        # dc sweeps each form S and take both (8 m B D and 4 m B)
        row.update(bound(6 * m * b * d, (m + b) * d * 2 + (m + b) * 4 + (m + b) * d * 4, exps=2 * m * b))
        inv2b, _, _ = _bwd_constants(b, 0.0)
        eye = torch.arange(m, device="cuda")

        def library():
            s = (nb @ cb.T).float()
            x = torch.exp(s - rl_m[:, None]) + torch.exp(s - cl[None, :])
            x[eye, eye + off] -= 2.0
            a = (inv2b * x).to(torch.bfloat16)
            return a @ cb, a.T @ nb

        timed(row, lambda: fl.fused_ce_bwd(*args), lambda: fused_ce_bwd_plain(*args), library, flush, runs)
    print(f"kernel {label}", json.dumps(row), flush=True)
    check(row["two_calls_equal"], f"{label} ({case}): two calls differ")
    check(rel <= CE_BWD_RTOL, f"{label} ({case}) vs plain: max err {rel} of max |plain| > {CE_BWD_RTOL}")
    return row


def ce_phase(flush: torch.Tensor) -> dict:
    """K6 and K11 at the training batch (timed) and the step check's batch;
    K7 and K10, the same kernels in the col-blocked range, at B=16384 and
    32768 (timed) with the other variant at 16384; the shifted forward at
    tau = 0.01 at B=8192 and 16384."""
    big = BLOCKED_BATCHES
    return {
        "fused_ce_fwd": [lean_case(flush, CE_BATCH, True, TIMED_RUNS), lean_case(flush, CE_BATCH, False, TIMED_RUNS),
                         lean_case(flush, GRAD_CHECK_BATCH, True), lean_case(flush, GRAD_CHECK_BATCH, False),
                         lean_case(flush, CE_BATCH, False, tau=LARGE_LOGIT_TAU),
                         lean_case(flush, CE_BATCH, True, TIMED_RUNS, rows=CE_BATCH // MESH_RANKS)],
        "fused_ce_bwd": [bwd_case(flush, CE_BATCH, runs=TIMED_RUNS), bwd_case(flush, CE_BATCH, shard=True,
                                                                              runs=TIMED_RUNS),
                         bwd_case(flush, GRAD_CHECK_BATCH)],
        "fused_ce_fwd_blocked": [lean_case(flush, b, True, LARGE_TIMED_RUNS, "fused_ce_fwd_blocked") for b in big]
        + [lean_case(flush, big[0], False, label="fused_ce_fwd_blocked"),
           lean_case(flush, big[0], False, label="fused_ce_fwd_blocked", tau=LARGE_LOGIT_TAU)],
        "fused_ce_bwd_blocked": [bwd_case(flush, b, runs=LARGE_TIMED_RUNS, label="fused_ce_bwd_blocked") for b in big]
        + [bwd_case(flush, big[0], eps=0.1, label="fused_ce_bwd_blocked")],
    }


def stats_inputs(b: int, seed: int = SEED, d: int = CE_DIM) -> tuple[torch.Tensor, torch.Tensor]:
    """Tower-like unit rows, N scaled by 1/STATS_TAU, each positive from
    near its row to nearly random, so the ranks spread from 0 to hundreds."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = unit_rows(gen, b, d, "cuda")
    noise = 0.5 + 11.5 * torch.rand(b, 1, generator=gen, device="cuda")
    c = n + noise * unit_rows(gen, b, d, "cuda")
    return n / STATS_TAU, c / c.norm(dim=1, keepdim=True)


def rank_gate(got: torch.Tensor, want: torch.Tensor, n_scaled, c, diag, row_offset: int, what: str) -> dict:
    """Ranks of the kernel against the plain version: at most
    RANK_ROW_SHARE of the rows may differ, each by no more than the number
    of its entries within NEAR_TIE_ATOL of the diagonal in the plain S (the
    diagonal's own column left out)."""
    rows = got.shape[0]
    bad = torch.nonzero(got != want).flatten()
    n_bad = int(bad.numel())
    check(n_bad <= RANK_ROW_SHARE * rows, f"{what}: ranks differ on {n_bad} of {rows} rows")
    worst, ties = 0, 0
    if n_bad:
        s = n_scaled[bad].to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
        near = (s - diag[bad, None]).abs() <= NEAR_TIE_ATOL
        near[torch.arange(n_bad, device=s.device), bad + row_offset] = False
        delta = (got[bad] - want[bad]).abs()
        near_ties = near.sum(1)
        check(bool((delta <= near_ties).all()),
              f"{what}: a rank differs by more than its row's near-ties ({delta.tolist()} vs {near_ties.tolist()})")
        worst, ties = int(delta.max()), int(near_ties.max())
    return {"rank_rows_differing": n_bad, "rank_max_diff": worst, "rank_max_near_ties": ties}


def stats_case(flush: torch.Tensor, b: int, runs: int = 0, row_offset: int = 0, rows: int = 0,
               d: int = CE_DIM) -> tuple[dict, dict]:
    """K8 and the statistics sweep (K5; K9 past B=8192) at batch b and width
    d against their plain versions on the same inputs (the sweep's plain
    version takes the kernel's diagonal), each two calls bit-equal; with
    ``rows`` a row shard of N from ``row_offset``. The kernels are reached
    through the module, so a fault planted there (planted_faults.py) shows
    here. Returns (the K8 row, the sweep row)."""
    n, c = stats_inputs(b, d=d)
    if rows:
        n = n[row_offset : row_offset + rows]
    m = n.shape[0]
    case = f"B={b} D={d} tau={STATS_TAU}" + (f" rows {row_offset}..{row_offset + m}" if rows else "")
    diag, diag_again = fl.same_tile_diag(n, c, row_offset), fl.same_tile_diag(n, c, row_offset)
    got, again = fl.fused_stats_sweep(n, c, diag, row_offset), fl.fused_stats_sweep(n, c, diag, row_offset)
    want_diag = same_tile_diag_plain(n, c, row_offset)
    want_rows, want_cols = fused_stats_sweep_plain(n, c, diag, row_offset)
    torch.cuda.synchronize()
    got_rows, got_cols = got
    diag_err = float((diag - want_diag).abs().max())
    diag_row = {"case": case, "two_calls_equal": torch.equal(diag, diag_again), "max_abs_err": diag_err,
                "tolerance": DIAG_ATOL}

    def abs_err(g, w):
        return float((g - w).abs().max())

    row_sum_err, col_sum_err = abs_err(got_rows[:, 1], want_rows[:, 1]), abs_err(got_cols[1], want_cols[1])
    errs = {
        "row_lse_abs_err": abs_err(got_rows[:, 0], want_rows[:, 0]),
        "col_lse_abs_err": abs_err(got_cols[0], want_cols[0]),
        "diag_passed_through": torch.equal(got_rows[:, 2], diag),
        "row_sum_rel_err": row_sum_err / float(want_rows[:, 1].abs().max()),
        "col_sum_rel_err": col_sum_err / float(want_cols[1].abs().max()),
        "sum_abs_err": max(row_sum_err, col_sum_err),
    }
    # rank against a diagonal below every S_ii: the diagonal's own column is
    # left out by index, so a kernel that left it out by value (S_ij != diag_i)
    # would count it in every row
    diag_low = diag - (1e-3 + 1e-3 * diag.abs())
    low_rank = fl.fused_stats_sweep(n, c, diag_low, row_offset)[0][:, 3]
    want_low = fused_stats_sweep_plain(n, c, diag_low, row_offset)[0][:, 3]
    stats_row = {"case": case, "two_calls_equal": all(torch.equal(x, y) for x, y in zip(got, again)),
                 "max_abs_err": max(errs["row_lse_abs_err"], errs["col_lse_abs_err"], errs["sum_abs_err"]),
                 **errs, "tolerance_lse": STATS_LSE_ATOL, "tolerance_sum_rel": STATS_SUM_RTOL,
                 "rank_mean": float(want_rows[:, 3].mean()),
                 **rank_gate(got_rows[:, 3], want_rows[:, 3], n, c, diag, row_offset, f"fused_stats {case}"),
                 "rank_below_diag": rank_gate(low_rank, want_low, n, c, diag_low, row_offset,
                                              f"fused_stats {case}, diag lowered")}
    if runs:
        nb, cb = n.to(torch.bfloat16), c.to(torch.bfloat16)
        # K8: the diagonal tiles' operands in, the diagonal out
        diag_row.update(bound(2 * m * 64 * d, 2 * m * d * 2 + m * 4))
        timed(diag_row, lambda: fl.same_tile_diag(nb, cb, row_offset),
              lambda: same_tile_diag_plain(nb, cb, row_offset),
              lambda: (nb * cb[row_offset : row_offset + m]).sum(1), flush, runs)
        # the sweep: products 2 m b d, two exponentials per entry, N, C and diag in, the statistics out
        stats_row.update(bound(2 * m * b * d, (m + b) * d * 2 + m * 4 + m * 16 + b * 8, exps=2 * m * b))

        def library():
            s = (nb @ cb.T).float()
            return torch.logsumexp(s, 1), s.sum(1), (s > diag[:, None]).sum(1), torch.logsumexp(s, 0), s.sum(0)

        timed(stats_row, lambda: fl.fused_stats_sweep(nb, cb, diag, row_offset),
              lambda: fused_stats_sweep_plain(nb, cb, diag, row_offset), library, flush, runs)
    print("kernel same_tile_diag", json.dumps(diag_row), flush=True)
    print("kernel fused_stats", json.dumps(stats_row), flush=True)
    check(diag_row["two_calls_equal"] and stats_row["two_calls_equal"], f"statistics kernels ({case}): two calls differ")
    check(diag_err <= DIAG_ATOL, f"same_tile_diag ({case}) vs plain: max abs err {diag_err} > {DIAG_ATOL}")
    check(errs["diag_passed_through"], f"fused_stats ({case}): row diag is not the diag it was given")
    for key in ("row_lse_abs_err", "col_lse_abs_err"):
        check(errs[key] <= STATS_LSE_ATOL, f"fused_stats ({case}) vs plain: {key} {errs[key]} > {STATS_LSE_ATOL}")
    for key in ("row_sum_rel_err", "col_sum_rel_err"):
        check(errs[key] <= STATS_SUM_RTOL, f"fused_stats ({case}) vs plain: {key} {errs[key]} > {STATS_SUM_RTOL}")
    return diag_row, stats_row


def stats_phase(flush: torch.Tensor) -> dict:
    """K8 with K5 at B=8192 (timed), 1024 and a row shard; with K9 at
    B=16384 and 32768 (timed). K8's record leads with B=16384, the shape
    the col-blocked eval runs it at."""
    k5 = [stats_case(flush, CE_BATCH, TIMED_RUNS), stats_case(flush, GRAD_CHECK_BATCH, TIMED_RUNS),
          stats_case(flush, CE_BATCH, row_offset=CE_BATCH // 2, rows=CE_BATCH // 4),
          # a mesh rank's block: rank 1 of 2 at B=8192
          stats_case(flush, CE_BATCH, TIMED_RUNS, row_offset=CE_BATCH // MESH_RANKS, rows=CE_BATCH // MESH_RANKS)]
    k9 = [stats_case(flush, b, LARGE_TIMED_RUNS) for b in BLOCKED_BATCHES]
    return {
        "same_tile_diag": [k9[0][0], k5[0][0], k5[1][0], k5[2][0], k5[3][0], k9[1][0]],
        "fused_stats": [r for _, r in k5],
        "fused_stats_blocked": [r for _, r in k9],
    }


def diag_bits_check(d: int, b: int = GRAD_CHECK_BATCH) -> dict:
    """K8's diagonal is bit for bit the S_ii of the sweep, at width d. C = N
    (unit rows), so S_ii is the largest entry of row i by a wide margin;
    row i of every even 64-row block gets a twin, C row i + 64 set to row i.
    The sweep forms S tiles of 64 rows by one consumer warpgroup's 64
    columns (wgmma m64n64k16; mma.sync 64-column tiles past D = 512), each
    slice starting at a multiple of 64, so it forms the twin S[i, i + 64]
    in the slice after S_ii's, from the same operands in the same
    accumulator position and depth order, hence to the same bits. Rank counts
    S_ij > diag_i strictly, so on N a planted row's rank is 0 exactly when
    K8's diag is not below the sweep's S_ii; on -N, which negates every
    product and sum exactly, S_ii is the row's smallest entry and the rank
    is B - 2 exactly when the diag is not above it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n = unit_rows(gen, b, d, "cuda")
    planted = torch.arange(b, device="cuda").view(-1, 64)[0::2].reshape(-1)
    c = n.clone()
    c[planted + 64] = n[planted]
    bad = {}
    for sign, want in ((1.0, 0), (-1.0, b - 2)):
        ns = sign * n / STATS_TAU
        rank = fl.fused_stats_sweep(ns, c, fl.same_tile_diag(ns, c))[0][planted, 3]
        bad["N" if sign > 0 else "-N"] = int((rank != want).sum())
    row = {"case": f"B={b} D={d} tau={STATS_TAU}, {planted.numel()} planted twins",
           "rows_where_diag_differs_from_sweep_s_ii": bad}
    print("kernel same_tile_diag bits " + json.dumps(row), flush=True)
    check(sum(bad.values()) == 0, f"same_tile_diag (D={d}): the diagonal differs from the sweep's S_ii: {bad}")
    return row


def wide_phase(flush: torch.Tensor) -> dict:
    """K5-K11 at D = 256 and 512 (two and four 128-deep chunks), at B=8192
    and in the col-blocked range at 16384, to the D = 128 tolerances, the
    lean forward nomax, the backward without label smoothing and the
    statistics timed; and K8 against the sweep's S_ii bit for bit at every
    width."""
    out = {k: [] for k in ("fused_ce_fwd", "fused_ce_bwd", "fused_ce_fwd_blocked", "fused_ce_bwd_blocked",
                           "same_tile_diag", "fused_stats", "fused_stats_blocked")}
    for d in WIDE_DIMS:
        for b in (CE_BATCH, BLOCKED_BATCHES[0]):
            tag = "_blocked" if b > CE_BATCH else ""
            out["fused_ce_fwd" + tag] += [lean_case(flush, b, True, WIDE_TIMED_RUNS, "fused_ce_fwd" + tag, d),
                                          lean_case(flush, b, False, label="fused_ce_fwd" + tag, d=d)]
            out["fused_ce_bwd" + tag] += [bwd_case(flush, b, runs=WIDE_TIMED_RUNS, label="fused_ce_bwd" + tag, d=d),
                                          bwd_case(flush, b, eps=0.1, label="fused_ce_bwd" + tag, d=d)]
            diag_row, stats_row = stats_case(flush, b, WIDE_TIMED_RUNS, d=d)
            out["same_tile_diag"].append(diag_row)
            out["fused_stats" + tag].append(stats_row)
    # past D = 512 the forward and the backward take their mma.sync branches: agreement only
    out["fused_ce_fwd"] += [lean_case(flush, CE_BATCH, nomax, d=CHUNKED_CE_DIM) for nomax in (True, False)]
    out["fused_ce_bwd"].append(bwd_case(flush, CE_BATCH, d=CHUNKED_CE_DIM))
    out["diag_bits"] = [diag_bits_check(d) for d in (CE_DIM,) + WIDE_DIMS]
    return out


def largest_batch_check() -> dict:
    """At B=65536, where the plain versions cannot run ([B, B] f32 is 17
    GB per temporary): the statistics forward (K8 + K9) against the lean
    forward (K7), lse within 1e-5 relative, and the label-smoothed loss
    (eps 0.1) and its gradients (K9, K10) finite and near log B (the TPU
    selftest's check_blocked_large)."""
    b = LARGEST_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n, c = unit_rows(gen, b, CE_DIM, "cuda"), unit_rows(gen, b, CE_DIM, "cuda")
    stats = fl.fused_stats(n, c, temperature=STATS_TAU)
    row_lean, col_lean = fl.fused_lean_lse(n / STATS_TAU, c, nomax=False)

    def rel(a, ref):
        return float(((a - ref).abs() / ref.abs().clamp_min(1e-6)).max())

    lse_err = max(rel(stats.row_lse, row_lean), rel(stats.col_lse, col_lean))
    nt, ct = n.clone().requires_grad_(True), c.clone().requires_grad_(True)
    loss = fl.fused_bidirectional_ce(nt, ct, STATS_TAU, 0.1)
    loss.backward()
    loss = float(loss.detach())
    finite = bool(np.isfinite(loss)) and bool(torch.isfinite(nt.grad).all()) and bool(torch.isfinite(ct.grad).all())
    row = {"case": f"B={b} D={CE_DIM} tau={STATS_TAU}", "stats_vs_lean_lse_max_rel_err": lse_err,
           "loss_eps0.1": loss, "log_b": float(np.log(b)), "finite": finite,
           "workspace_mb": {"fused_stats": fl.stats_launch_shape(b, b, CE_DIM).workspace_floats * 4 / 2**20,
                            "fused_lean_lse": fl.lean_lse_launch_shape(b, b, CE_DIM, False).workspace_floats * 4 / 2**20}}
    print("kernel largest batch " + json.dumps(row), flush=True)
    check(lse_err < 1e-5, f"B={b}: statistics lse vs lean lse max rel err {lse_err}")
    check(finite and abs(loss - np.log(b)) < 2.0, f"B={b}: label-smoothed loss {loss} or its grads")
    return row


def table_grad_inputs(batch: int = CE_BATCH) -> list[tuple[str, torch.Tensor, torch.Tensor, torch.Tensor, bool]]:
    """The table gradient's cases, (name, rows, g, tile_feature, timed): the
    training path's two shapes (the ids of the bench's synthetic data,
    cluster-correlated as the step sees them, a bf16 cotangent ~ N(0, 1));
    a skewed batch whose every id of a feature hits one row (8192 values of
    scale 0.01 on each of 32 rows); the dense envelope's edge, R = 65,536
    (64 features of vocab 1,000, ids uniform); a ragged B=1000 batch whose
    ids reach other features' blocks, their own block's padding, -1 and
    past the table (agreement only: the library call takes no such ids);
    and the multihost smoke's compressed Trainer shape, B=32 at D=8, with
    the ragged batch at D=24 and D=40 (agreement only: the widths whose
    g rows the kernel reads in 8-byte pieces)."""
    gen = np.random.default_rng(SEED + 2)
    schema = reference_shaped_schema()
    ds = make_synthetic_dataset(schema, n_notices=20_000, n_companies=20_000, n_pairs=batch,
                                n_clusters=bench.N_CLUSTERS, seed=SEED)

    def case(name, vocabs, rows, scale=1.0, timed=True, d=32):
        g = gen.normal(0.0, scale, size=(*rows.shape, d)).astype(np.float32)
        return (f"{name} B={rows.shape[0]} K={rows.shape[1]} R={table_layout(vocabs)[1]} D={d}",
                torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to("cuda"),
                torch.from_numpy(g).to("cuda", torch.bfloat16),
                torch.from_numpy(tile_feature_map(vocabs)).to("cuda"), timed)

    out = []
    for name, side, store, col in (("notice", schema.notice, ds.notice_store, 0),
                                   ("company", schema.company, ds.company_store, 1)):
        out.append(case(name, side.vocab_sizes, store.cat_ids[ds.pairs[:, col]] + table_layout(side.vocab_sizes)[0]))
    vocabs = schema.notice.vocab_sizes
    offsets = table_layout(vocabs)[0]
    out.append(case("notice skewed", vocabs, np.broadcast_to(offsets + 7, (batch, len(vocabs))), scale=0.01))
    wide = (1000,) * GRAD_ENVELOPE_FEATURES
    ids = gen.integers(0, 1000, size=(batch, len(wide)))
    out.append(case("envelope", wide, ids + table_layout(wide)[0][None, :]))
    ragged = lookup_case("ragged", vocabs, 1000, torch.float32, gen, ragged=True)["rows"].cpu().numpy()
    out.append(case("notice ragged", vocabs, ragged, timed=False))
    small = make_synthetic_dataset(seed=0, n_notices=multihost_smoke.N_ROWS, n_companies=multihost_smoke.N_ROWS,
                                   n_pairs=multihost_smoke.N_PAIRS)
    side = small.schema.notice
    small_rows = small.notice_store.cat_ids[small.pairs[:multihost_smoke.BATCH // 2, 0]]
    out.append(case("multihost compressed notice", side.vocab_sizes,
                    small_rows + table_layout(side.vocab_sizes)[0][None, :], timed=False, d=8))
    for d in (24, 40):
        out.append(case("notice ragged", vocabs, ragged, timed=False, d=d))
    return out


def table_grad_phase(flush: torch.Tensor | None, runs: int = TIMED_RUNS) -> tuple[list[dict], list[dict]]:
    """The table gradient (K2, and K3, its [D, R] form) at each case of
    :func:`table_grad_inputs`: two calls bit-equal, within GRAD_ATOL of the
    plain version, K3 equal to K2's output transposed; with ``runs``, each
    timed case beside its bound, the plain version and the library call, and
    K2 at every cluster size. Also the build's ptxas report (no spill) and a
    launch the card refuses (a cluster past its largest), which must raise.
    Returns (K2's rows, K3's rows)."""
    build = ptxas_report(_build.build_log("table_grad"))
    print("ptxas table_grad " + json.dumps(build), flush=True)
    check(bool(build) and all(f.get("spill_store_bytes", 0) == 0 == f.get("spill_load_bytes", 0) for f in build),
          f"table_grad spills: {build}")
    rows_out, bmajor = [], []
    for name, rows, g, tf, is_timed in table_grad_inputs():
        b, total = rows.shape[0], TILE_ROWS * tf.numel()
        cluster, grid = table_grad_launch_shape(b, total)
        # through the module, so a fault planted there (planted_faults.py) shows here
        got, again, want = eg.dense_table_grad(rows, g, tf), eg.dense_table_grad(rows, g, tf), dense_table_grad_plain(rows, g, tf)
        got_t, again_t = eg.dense_table_grad_bmajor(rows, g, tf), eg.dense_table_grad_bmajor(rows, g, tf)
        want_t = dense_table_grad_bmajor_plain(rows, g, tf)
        torch.cuda.synchronize()
        nbytes = rows.numel() * 4 + g.numel() * 2 + total * g.shape[2] * 4 + tf.numel() * 4
        row = {"case": name, "cluster": cluster, "grid": grid, "two_calls_equal": torch.equal(got, again),
               "max_abs_err": float((got - want).abs().max()), "tolerance": GRAD_ATOL, **bound(0, nbytes)}
        row_t = {"case": name, "cluster": cluster, "grid": grid, "equal_to_k2_transposed": torch.equal(got_t, got.t()),
                 "two_calls_equal": torch.equal(got_t, again_t), "max_abs_err": float((got_t - want_t).abs().max()),
                 "tolerance": GRAD_ATOL, **bound(0, nbytes)}
        if runs and is_timed:
            rows_flat, g_flat = rows.reshape(-1).long(), g.reshape(-1, 32)

            def library():
                return torch.zeros(total, 32, device="cuda").index_add_(0, rows_flat, g_flat.float())

            timed(row, lambda: eg.dense_table_grad(rows, g, tf), lambda: dense_table_grad_plain(rows, g, tf), library,
                  flush, runs)
            timed(row_t, lambda: eg.dense_table_grad_bmajor(rows, g, tf),
                  lambda: dense_table_grad_bmajor_plain(rows, g, tf), lambda: library().t().contiguous(), flush, runs)
            row["by_cluster"] = {}
            for c in GRAD_CLUSTERS:  # the same kernel at every cluster size it takes: right at each, and its time
                launch = lambda c=c: eg._table_grad_launch(rows, g, tf, transposed=False, cluster=c)  # noqa: E731
                first, second = launch(), launch()
                torch.cuda.synchronize()
                err = float((first - want).abs().max())
                check(torch.equal(first, second) and err <= GRAD_ATOL,
                      f"table_grad ({name}) at cluster {c}: two calls differ or max abs err {err} > {GRAD_ATOL}")
                row["by_cluster"][c] = {"ms": median_ms(launch, flush, runs), "max_abs_err": err}
        print("kernel table_grad", json.dumps(row), flush=True)
        print("kernel table_grad_bmajor", json.dumps(row_t), flush=True)
        for what, r in (("table_grad", row), ("table_grad_bmajor", row_t)):
            check(r["max_abs_err"] <= GRAD_ATOL, f"{what} ({name}) vs plain: max abs err {r['max_abs_err']} > {GRAD_ATOL}")
            check(r["two_calls_equal"], f"{what} ({name}): two calls differ")
        check(row_t["equal_to_k2_transposed"], f"table_grad_bmajor ({name}) != table_grad transposed")
        rows_out.append(row)
        bmajor.append(row_t)
    # a launch the card refuses (the last case's inputs) raises: no other launch takes its place
    try:
        eg._table_grad_launch(rows, g, tf, transposed=False, cluster=REFUSED_CLUSTER)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    print("table_grad refused launch " + json.dumps({"cluster": REFUSED_CLUSTER, "error": refused}), flush=True)
    check(refused is not None, f"table_grad launched with a cluster of {REFUSED_CLUSTER} CTAs; the card should refuse it")
    return rows_out, bmajor


def scaled_rows(batch: int, seed: int = SEED) -> tuple[torch.Tensor, int]:
    """Absolute rows [batch, 8] of the scaled tables, ids uniform over each
    1.25M vocab from numpy seed ``seed``; returns them and the table's rows."""
    offsets, total = table_layout((SCALED_VOCAB,) * SCALED_FEATURES)
    ids = np.random.default_rng(seed).integers(0, SCALED_VOCAB, size=(batch, SCALED_FEATURES))
    return torch.from_numpy((ids + offsets[None, :]).astype(np.int32)).to("cuda"), total


def row_gather_bytes(ids: torch.Tensor, read_rows: torch.Tensor, row_bytes: int) -> int:
    """Least bytes K4 must move: the ids read, each distinct row of
    ``read_rows`` (the rows the function reads) read once, the output
    written once."""
    return ids.numel() * ids.element_size() + (int(torch.unique(read_rows).numel()) + ids.numel()) * row_bytes


def row_gather_case(flush: torch.Tensor | None, case: str, fn, plain, library, nbytes: int, **extra) -> dict:
    """One K4 case's row: ``fn`` (through the module, so a fault planted
    there shows here) bit-exact against ``plain``; with ``flush``, the
    kernel, the plain version and ``library`` timed beside the bound."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    equal = torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32),
                        want.view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32))
    err = float((got.float() - want.float()).abs().nan_to_num(0.0).max())
    check(equal and got.dtype == want.dtype, f"row_gather != plain version, case {case} (max abs err {err})")
    row = {"case": case, "equal": equal, "max_abs_err": err, "shape": list(got.shape), "dtype": str(got.dtype),
           **extra, **bound(0, nbytes)}
    if flush is not None:
        timed(row, fn, plain, library, flush)
    return row


def row_gather_phase(flush: torch.Tensor | None) -> list[dict]:
    """K4 at the scaled_dense path's shape (a [10,000,384, 64] f32 table,
    rows [8192, 8]), on a bf16 table of that shape, on a ragged B=1000 batch
    with rows at -1 and past the table and on int64 rows with ids at 2^32 + 5
    and -2^32 + 3 (clamped to the edge rows, not wrapped); then its zero form
    on a mesh rank's block (``masked_shard_gather``, the mesh_rows path's
    call), on rank 1's block with the ids of the f32 case, and on rank 1's
    and rank 0's blocks with the block's edge ids planted, as int32 and
    int64. Every case bit-exact against its plain version; with ``flush``
    timed beside index_select on the clamped rows. One masked gather runs
    one CUDA kernel, K4 (the profiler counts them)."""
    rows, total = scaled_rows(CE_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    table = torch.randn(total, SCALED_DIM, generator=gen, device="cuda")
    ragged = rows[:1000].clone()
    ragged[::97, 0] = -1
    ragged[5::101, 3] = total + 3
    wide = rows.long()  # C12: int64 ids read at their width, past 2^31 clamped as XLA clamps
    wide[::97, 0] = 2**32 + 5
    wide[5::101, 3] = -(2**32) + 3
    results = []
    for case, t, r in ((f"f32 table [{total}, {SCALED_DIM}] rows [{CE_BATCH}, {SCALED_FEATURES}]", table, rows),
                       (f"bf16 table [{total}, {SCALED_DIM}] rows [{CE_BATCH}, {SCALED_FEATURES}]",
                        table.to(torch.bfloat16), rows),
                       (f"ragged B=1000 rows [1000, {SCALED_FEATURES}], -1 and R+3 clamped", table, ragged),
                       (f"int64 rows [{CE_BATCH}, {SCALED_FEATURES}], 2^32+5 and -2^32+3 clamped", table, wide)):
        safe = r.reshape(-1).long().clamp(0, total - 1)
        results.append(row_gather_case(
            flush, case, lambda t=t, r=r: el.embedding_lookup_pallas(t, r),
            lambda t=t, r=r: embedding_lookup_pallas_plain(t, r), lambda t=t, safe=safe: t.index_select(0, safe),
            row_gather_bytes(r, safe, SCALED_DIM * t.element_size())))
        print("kernel row_gather", json.dumps(results[-1]), flush=True)
    edge = table[total - 1], table[0]
    got = el.embedding_lookup_pallas(table, wide)
    check(torch.equal(got[0, 0], edge[0]) and torch.equal(got[5, 3], edge[1]),
          "row_gather: int64 ids 2^32+5 and -2^32+3 did not read rows R-1 and 0")
    # the zero form on a rank's block [R/2, 64] of the table (the mesh_rows
    # path: ids over the whole table, about half inside the block)
    block_rows = total // 2
    ids = rows.reshape(-1)
    for rank, id_dtype, planted in ((1, torch.int32, False), (1, torch.int32, True), (1, torch.int64, True),
                                    (0, torch.int32, True), (0, torch.int64, True)):
        offset = rank * block_rows
        block = table[offset:offset + block_rows]
        case_ids = ids.to(id_dtype)
        if planted:  # the edge ids: just outside, first, last, just past, -1, past the table
            case_ids = case_ids.clone()
            edges = [offset - 1, offset, offset + block_rows - 1, offset + block_rows, -1, total + 3]
            if id_dtype == torch.int64:  # an id that an int32 cast would wrap into the block
                edges.append(offset + 2**32)
            case_ids[: 101 * len(edges): 101] = torch.tensor(edges, dtype=id_dtype, device="cuda")
        local, in_range = local_rows(case_ids, offset, block_rows)
        case = (f"masked shard [{block_rows}, {SCALED_DIM}] of [{total}, {SCALED_DIM}] at {offset}, "
                f"ids [{ids.numel()}] {str(id_dtype).split('.')[-1]}" + (", edge ids planted" if planted else ""))
        row = row_gather_case(
            flush, case, lambda b=block, i=case_ids, o=offset: masked_shard_gather(b, i, o, use_pallas=True),
            lambda b=block, i=case_ids, o=offset: el.embedding_lookup_pallas_shard_plain(b, i, o),
            lambda b=block, lo=local: b.index_select(0, lo),
            # only the rows inside the block are read: the rest cost their write
            row_gather_bytes(case_ids, local[in_range], SCALED_DIM * 4),
            in_range_share=float(in_range.float().mean()))
        if flush is not None and not planted:  # the masked case timed as the whole masked gather
            row["masked_gather_ms"] = median_ms(lambda: masked_shard_gather(block, ids, offset, use_pallas=True), flush)
            one = device_breakdown(lambda: masked_shard_gather(block, ids, offset, use_pallas=True), repeats=1)
            row["device_kernels_per_call"] = one["device_events_per_call"]
            row["device_kernels"] = list(one["top_ms"])
            print("row_gather masked gather on the card " + json.dumps(one), flush=True)
            check(one["device_events_per_call"] == 1 and "row_gather" in row["device_kernels"][0],
                  f"masked_shard_gather ran {one['device_events_per_call']} CUDA kernels, not K4 alone: "
                  f"{row['device_kernels']}")
        print("kernel row_gather", json.dumps(row), flush=True)
        results.append(row)
    return results


def topk_blocks(order: str, seed: int = SEED) -> list[torch.Tensor]:
    """The serving cells' 39 [256, 262,144] float32 score blocks in one of
    three orders: ``random``, products of unit vectors (D = 128) drawn on
    the card from ``seed``; ``ascending``, every score its row's number, so
    every chunk beats the running threshold and every slice runs the
    select; ``tied``, every score 0.5, so ties decide every place."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    queries = torch.nn.functional.normalize(
        torch.randn(TOPK_QUERIES, CE_DIM, generator=gen, device="cuda"), dim=1)
    blocks = []
    for ci in range(TOPK_CHUNKS):
        if order == "random":
            rows = torch.randn(TOPK_ROWS, CE_DIM, generator=gen, device="cuda")
            blocks.append(queries @ torch.nn.functional.normalize(rows, dim=1).T)
        elif order == "ascending":
            row = torch.arange(ci * TOPK_ROWS, (ci + 1) * TOPK_ROWS, device="cuda").float()
            blocks.append(row.expand(TOPK_QUERIES, -1).contiguous())
        else:
            blocks.append(torch.full((TOPK_QUERIES, TOPK_ROWS), 0.5, device="cuda"))
    return blocks


def topk_scan(blocks: list[torch.Tensor], k: int, how: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The running top-k over ``blocks`` (chunk ci is rows ci x 262,144 on,
    valid below 10,000,000): ``kernel`` through ``ct.chunk_topk``,
    ``plain`` through its plain version, ``library`` as the scan was before
    the kernel (``torch.topk`` of each block, the last masked, and
    ``_merge_topk``)."""
    best_s = torch.full((TOPK_QUERIES, k), ct.NEG, device="cuda")
    best_i = torch.zeros((TOPK_QUERIES, k), dtype=torch.int64, device="cuda")
    work = ct.workspace(TOPK_QUERIES, k, TOPK_ROWS, best_s.device)
    cols = torch.arange(TOPK_ROWS, device="cuda")
    for ci, block in enumerate(blocks):
        row0 = ci * TOPK_ROWS
        if how == "kernel":
            best_s, best_i = ct.chunk_topk(best_s, best_i, block, row0, TOPK_VALID, work)
        elif how == "plain":
            best_s, best_i = ct.chunk_topk_plain(best_s, best_i, block, row0, TOPK_VALID)
        else:
            if row0 + TOPK_ROWS > TOPK_VALID:
                block = torch.where(row0 + cols[None, :] < TOPK_VALID, block, ct.NEG)
            s, i = torch.topk(block, k, dim=1)
            best_s, best_i = _merge_topk(best_s, best_i, s, i + row0, k)
    return best_s, best_i


def topk_index_check(k: int) -> dict:
    """``_scanned_topk`` on the card over a chunked exact index of 2,000,000
    rows (8 chunks of 262,144, the last part padding), profiled: no kernel
    of torch's top-k runs, the kernel's two launches a chunk do, and the
    wrapper counts them; then one chunk of every row (an index without
    corpus_chunk and a ShardedIndex rank's form: 8 steps of 262,144
    columns) and an odd width (1,001 columns, scalar loads), each equal to
    the plain version."""
    from torch.profiler import profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    q = torch.nn.functional.normalize(torch.randn(TOPK_QUERIES, CE_DIM, generator=gen, device="cuda"), dim=1)
    n = 2_000_000
    index = BruteForceIndex(torch.nn.functional.normalize(torch.randn(n, CE_DIM, generator=gen, device="cuda"), dim=1),
                            corpus_chunk=TOPK_ROWS, device="cuda")
    corpus = index.corpus
    nc = corpus.shape[0]

    def scan():
        return _scanned_topk(lambda qs, ci: qs @ corpus[ci].T, nc, TOPK_ROWS, n, q, k)

    scan()
    torch.cuda.synchronize()
    before = ct.chunk_topk.launches
    with profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = scan()
        torch.cuda.synchronize()
    launches = ct.chunk_topk.launches - before
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    library = sorted({x for x in names if TORCH_TOPK_KERNELS.search(x)})
    ours = sum("slice_select_kernel" in x or "merge_kernel" in x for x in names)
    check(not library, f"the chunked scan ran torch's top-k kernels: {library}")
    check(ours == launches == 2 * nc, f"the chunked scan: {ours} kernel events, {launches} counted, {2 * nc} expected")
    flat = corpus.reshape(-1, CE_DIM)
    want = ct.chunk_topk_plain(torch.full((TOPK_QUERIES, k), ct.NEG, device="cuda"),
                               torch.zeros((TOPK_QUERIES, k), dtype=torch.int64, device="cuda"), q @ flat.T, 0, n)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "chunked _scanned_topk != one plain step over the whole corpus")
    whole = _scanned_topk(lambda qs, _: qs @ flat.T, 1, flat.shape[0], n, q, k)
    check(torch.equal(whole[0], want[0]) and torch.equal(whole[1], want[1]),
          "one-chunk _scanned_topk != the plain version")
    odd = (q @ flat[:1001].T)[:, :1001]
    got_odd = _scanned_topk(lambda qs, _: odd, 1, 1001, 999, q, min(k, 999))
    want_odd = ct.chunk_topk_plain(torch.full((TOPK_QUERIES, min(k, 999)), ct.NEG, device="cuda"),
                                   torch.zeros((TOPK_QUERIES, min(k, 999)), dtype=torch.int64, device="cuda"),
                                   odd, 0, 999)
    check(torch.equal(got_odd[0], want_odd[0]) and torch.equal(got_odd[1], want_odd[1]),
          "_scanned_topk over 1,001 columns (999 valid) != the plain version")
    return {"k": k, "chunks": nc, "kernel_events": ours, "launches": launches, "torch_topk_kernels": library}


def topk_fuzz_check(cases: int = 48, seed: int = SEED + 22) -> dict:
    """Chains of three steps at drawn shapes: queries 1-300, widths 1 to
    600,000 (past a step's 262,144, and not a multiple of 4), k 1-1024 (at,
    below and above a slice's 8,192 columns' worth of passing scores), valid
    counts cutting any step, a row stride wider than the block, and scores
    drawn from a normal, from a few integers (ties everywhere) or sorted;
    the kernel bit-equal to the plain version at every step."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for case in range(cases):
        q, c = int(rng.integers(1, 301)), int(rng.choice([1, 7, 1001, 8192, 8193, 70_000, 262_144, 600_001]))
        k = int(rng.choice([1, 5, 100, 400, 1000, 1024]))
        n_valid = int(rng.integers(0, 3 * c + 1))
        kind = ["normal", "integers", "sorted"][case % 3]
        s_k = torch.full((q, k), ct.NEG, device="cuda")
        i_k = torch.zeros((q, k), dtype=torch.int64, device="cuda")
        s_p, i_p = s_k.clone(), i_k.clone()
        for step in range(3):
            if kind == "normal":
                block = torch.randn(q, c + 3, generator=gen, device="cuda")[:, :c]  # row stride c + 3
            elif kind == "integers":
                block = torch.randint(-2, 3, (q, c + 3), generator=gen, device="cuda").float()[:, :c]
            else:
                block = torch.arange(step * c, (step + 1) * c, dtype=torch.float32, device="cuda").expand(q, -1)
                block = block * (1 - 2 * (q % 2))
            s_k, i_k = ct.chunk_topk(s_k, i_k, block, step * c, n_valid)
            s_p, i_p = ct.chunk_topk_plain(s_p, i_p, block, step * c, n_valid)
            check(torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)) and torch.equal(i_k, i_p),
                  f"chunk_topk != plain: case {case} ({kind}, q={q}, c={c}, k={k}, n_valid={n_valid}), step {step}")
    return {"cases": cases, "steps": 3 * cases}


def chunk_topk_phase(flush: torch.Tensor | None) -> list[dict]:
    """The index scan's top-k kernel at the serving cells' shape, k 100 and
    400, on random, ascending and tied scores: the 39-chunk scan bit-equal
    to the plain version (scores and rows), its scores equal to torch.topk's
    and ``_merge_topk``'s, and each order's device tally; with ``flush``,
    the ms a chunk (the whole scan over 39, the first chunk, a later chunk)
    beside the bound (the block's bytes read once), the plain version's and
    the library's. Then :func:`topk_index_check` at each k."""
    rows = [{"case": "fuzz", **topk_fuzz_check()}]
    print("kernel chunk_topk", json.dumps(rows[0]), flush=True)
    per_chunk = bound(0, TOPK_QUERIES * TOPK_ROWS * 4)
    for order in ("random", "ascending", "tied"):
        blocks = topk_blocks(order)
        for k in TOPK_KS:
            ct.reset_tally()
            got = topk_scan(blocks, k, "kernel")
            tally = ct.tally()
            want = topk_scan(blocks, k, "plain")
            lib = topk_scan(blocks, k, "library")
            torch.cuda.synchronize()
            equal = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])
            check(equal, f"chunk_topk != plain version, {order} k={k}")
            check(torch.equal(got[0], lib[0]), f"chunk_topk's scores != torch.topk's, {order} k={k}")
            if order == "ascending":
                top = torch.arange(TOPK_VALID - 1, TOPK_VALID - 1 - k, -1, device="cuda")
                check(torch.equal(got[1], top.expand(TOPK_QUERIES, -1)), f"ascending k={k}: not the last k rows")
            if order == "tied":
                check(torch.equal(got[1], torch.arange(k, device="cuda").expand(TOPK_QUERIES, -1)),
                      f"tied k={k}: not the first k rows")
            row = {"case": f"{order} [{TOPK_QUERIES}, {TOPK_ROWS}] x {TOPK_CHUNKS} chunks, {TOPK_VALID} valid, k={k}",
                   "equal": equal, "max_abs_err": 0.0, "rows_unlike_library": int((got[1] != lib[1]).sum()),
                   "tally": {**tally, "no_select_share": 1 - tally["selected"] / tally["slices"]}, **per_chunk}
            if flush is not None and order != "tied":
                row["ms"] = median_ms(lambda: topk_scan(blocks, k, "kernel"), flush, TOPK_TIMED_RUNS) / TOPK_CHUNKS
                row["plain_ms"] = median_ms(lambda: topk_scan(blocks, k, "plain"), flush, 3) / TOPK_CHUNKS
                row["library_ms"] = median_ms(lambda: topk_scan(blocks, k, "library"), flush,
                                              TOPK_TIMED_RUNS) / TOPK_CHUNKS
                fresh_s = torch.full((TOPK_QUERIES, k), ct.NEG, device="cuda")
                fresh_i = torch.zeros((TOPK_QUERIES, k), dtype=torch.int64, device="cuda")
                late_s, late_i = topk_scan(blocks[:-2], k, "kernel")
                state_s, state_i = fresh_s.clone(), fresh_i.clone()
                work = ct.workspace(TOPK_QUERIES, k, TOPK_ROWS, state_s.device)
                # each call restores the running top-k first (two copies of [256, k])
                row["first_chunk_ms"] = median_ms(
                    lambda: ct.chunk_topk(state_s.copy_(fresh_s), state_i.copy_(fresh_i), blocks[0], 0, TOPK_VALID,
                                          work), flush)
                row["later_chunk_ms"] = median_ms(
                    lambda: ct.chunk_topk(state_s.copy_(late_s), state_i.copy_(late_i), blocks[-2],
                                          (TOPK_CHUNKS - 2) * TOPK_ROWS, TOPK_VALID, work), flush)
            print("kernel chunk_topk", json.dumps(row), flush=True)
            rows.append(row)
        del blocks
        torch.cuda.empty_cache()
    for k in TOPK_KS:
        rows.append({"case": f"index scan k={k}", **topk_index_check(k)})
        print("kernel chunk_topk", json.dumps(rows[-1]), flush=True)
    return rows


def int8_scan_operands(q: int, c: int, d: int, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    """bf16 queries [q, d] (normal, spread over four binades), int8 rows [c,
    d] over the whole range, float32 scales [c] with every seventh 0 (the
    index's zero rows and chunk padding)."""
    queries = (torch.randn(q, d, generator=gen, device="cuda")
               * 2.0 ** torch.randint(-2, 2, (q, 1), generator=gen, device="cuda")).to(torch.bfloat16)
    values = torch.randint(-127, 128, (c, d), generator=gen, device="cuda", dtype=torch.int8)
    scales = torch.rand(c, generator=gen, device="cuda") * 0.02
    scales[::7] = 0.0
    return queries, values, scales


def int8_scan_gap(got: torch.Tensor, queries: torch.Tensor, values: torch.Tensor,
                  scales: torch.Tensor) -> tuple[float, float]:
    """The kernel's widest distance from the plain version, in float32 ulps
    of sum |q v| x scale (its score's own scale: both sum the same exact
    products, in another order), and in absolute terms; fails above
    INT8_SCAN_ULPS or on a zero-scale row that is not 0."""
    diff = (got - i8.int8_scan_plain(queries, values, scales)).abs()
    mag = (queries.float().abs() @ values.float().abs().T) * scales[None, :]
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 24)
    gap = float((diff / ulp).nan_to_num(0.0).max())  # 0 / 0 where mag is 0
    check(gap <= INT8_SCAN_ULPS, f"int8_scan != plain: {gap:.3g} ulps of sum |q v| x scale, "
                                 f"shape {tuple(queries.shape)} x {tuple(values.shape)}")
    check(not got[:, scales == 0].any(), "int8_scan: a zero-scale row scored other than 0")
    return gap, float(diff.max())


def int8_scan_fuzz_check(cases: int = 40, seed: int = SEED + 24) -> dict:
    """The kernel against its plain version at drawn shapes: queries 1-1,100
    (one to five query tiles, ragged), rows 1 to 300,000 (ragged against
    the 64-row tile and the 4-column row stride), depths 1-1024 (each query
    tile width, ragged K tiles, the byte loads where D is not a multiple of
    16), the rows at an odd offset into a larger block; then the same rows
    at another offset, and fewer queries, scored bit for bit alike."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for case in range(cases):
        q = int(rng.choice([1, 7, 64, 255, 256, 257, 600, 1100]))
        c = int(rng.choice([1, 3, 63, 65, 1001, 4097, 70_001, 262_144, 300_000]))
        d = int(rng.choice([1, 8, 16, 32, 48, 64, 100, 128, 130, 200, 256, 320, 500, 512, 513, 700, 1024]))
        queries, values, scales = int8_scan_operands(q, c + 5, d, gen)
        values, scales = values[5:], scales[5:].contiguous()  # rows 5 x d bytes in
        got = i8.int8_scan(queries, values, scales)
        worst = max(worst, int8_scan_gap(got, queries, values, scales)[0])
        off = int(rng.integers(0, c))
        part = i8.int8_scan(queries[: max(1, q // 3)], values[off:], scales[off:])
        check(torch.equal(part.view(torch.int32), got[: max(1, q // 3), off:].view(torch.int32)),
              f"int8_scan: case {case} (q={q}, c={c}, d={d}) scored rows {off}.. or the first queries differently "
              f"when they start the block")
    return {"cases": cases, "max_gap_ulps": worst}


def int8_scan_index_check(k: int = 100) -> dict:
    """``Int8Index.topk_body`` over the serving cells' corpus, 10,000,000
    rows in 39 chunks of 262,144 (no rescore), profiled: one int8_scan
    launch a chunk, counted by the wrapper, no float32 GEMM and no kernel
    whose count grows with the chunks but the scan's; its top-k scores
    within the kernel's gap of the plain version's scan."""
    from torch.profiler import profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    corpus = torch.nn.functional.normalize(torch.randn(TOPK_VALID, CE_DIM, generator=gen, device="cuda"), dim=1)
    index = Int8Index(corpus, corpus_chunk=TOPK_ROWS, device="cuda")
    del corpus
    q = torch.nn.functional.normalize(torch.randn(TOPK_QUERIES, CE_DIM, generator=gen, device="cuda"), dim=1)
    nc = index.values.shape[0]
    index.topk_body(q, k)
    torch.cuda.synchronize()
    before = i8.int8_scan.launches
    with profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got_s, _ = index.topk_body(q, k)
        torch.cuda.synchronize()
    launches = i8.int8_scan.launches - before
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = sum("int8_scan_kernel" in x for x in names)
    topk = sum("slice_select_kernel" in x or "merge_kernel" in x for x in names)
    gemms = sorted({x for x in names if "gemm" in x.lower()})
    others = collections.Counter(x for x in names
                                 if "int8_scan_kernel" not in x and "slice_select_kernel" not in x
                                 and "merge_kernel" not in x)
    check(ours == launches == nc, f"Int8Index.topk_body: {ours} int8_scan events, {launches} counted, {nc} chunks")
    check(topk == 2 * nc, f"Int8Index.topk_body: {topk} top-k kernel events for {nc} chunks")
    check(not gemms, f"Int8Index.topk_body ran GEMMs: {gemms}")
    check(sum(others.values()) < nc, f"Int8Index.topk_body: kernels besides the scan's grow with the chunks: {others}")
    qbf = q.to(torch.bfloat16)
    want_s, _ = _scanned_topk(lambda qs, ci: i8.int8_scan_plain(qs, index.values[ci], index.scales[ci, :, 0]),
                              nc, TOPK_ROWS, TOPK_VALID, qbf, k)
    mag = max(float((qbf.float().abs() @ index.values[ci].float().abs().T * index.scales[ci, :, 0]).max())
              for ci in range(nc))
    top_gap = float((got_s - want_s).abs().max())
    check(top_gap <= INT8_SCAN_ULPS * mag * 2.0**-23, f"Int8Index.topk_body: top-k scores {top_gap} from the plain scan's")
    return {"chunks": nc, "kernel_events": ours, "launches": launches, "topk_events": topk, "gemms": gemms,
            "other_kernels": dict(others), "top_k_score_gap": top_gap}


def int8_scan_phase(flush: torch.Tensor | None) -> list[dict]:
    """The int8 scan's product (``ops/int8_scan``): the fuzz check, then the
    serving cells' chunk [256, 262,144, 128] on four chunks against the
    plain version and, with ``flush``, timed a chunk beside its bound (the
    int8 rows, scales and queries read once, the float32 block written
    once), the plain version (the rows widened to float32, a float32 GEMM,
    the scale) and torch.matmul of the rows widened to bf16 beforehand (bf16
    out); a 39-chunk scan of products a chunk; then
    :func:`int8_scan_index_check`."""
    rows = [{"case": "fuzz", **int8_scan_fuzz_check()}]
    print("kernel int8_scan", json.dumps(rows[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    q = torch.nn.functional.normalize(torch.randn(TOPK_QUERIES, CE_DIM, generator=gen, device="cuda"), dim=1)
    qbf = q.to(torch.bfloat16)
    blocks = []
    for _ in range(4):
        rows_f = torch.nn.functional.normalize(torch.randn(TOPK_ROWS, CE_DIM, generator=gen, device="cuda"), dim=1)
        blocks.append(quantize_int8(rows_f))
    gaps = [int8_scan_gap(i8.int8_scan(qbf, v, s[:, 0]), qbf, v, s[:, 0]) for v, s in blocks]
    nbytes = TOPK_QUERIES * TOPK_ROWS * 4 + TOPK_ROWS * CE_DIM + TOPK_ROWS * 4 + TOPK_QUERIES * CE_DIM * 2
    row = {"case": f"serving chunk [{TOPK_QUERIES}, {TOPK_ROWS}, {CE_DIM}]", "max_gap_ulps": max(g[0] for g in gaps),
           "max_abs_err": max(g[1] for g in gaps), **bound(2 * TOPK_QUERIES * TOPK_ROWS * CE_DIM, nbytes)}
    if flush is not None:
        v, s = blocks[0]
        s0 = s[:, 0]
        vbf = v.to(torch.bfloat16)
        timed(row, lambda: i8.int8_scan(qbf, v, s0), lambda: i8.int8_scan_plain(qbf, v, s0),
              lambda: torch.matmul(qbf, vbf.T), flush)
        del vbf
        scan_v = torch.stack([b[0] for b in blocks] * 10)[:TOPK_CHUNKS]
        scan_s = torch.stack([b[1][:, 0] for b in blocks] * 10)[:TOPK_CHUNKS]

        def scan():
            for ci in range(TOPK_CHUNKS):
                i8.int8_scan(qbf, scan_v[ci], scan_s[ci])

        row["scan_ms_per_chunk"] = median_ms(scan, flush, TOPK_TIMED_RUNS) / TOPK_CHUNKS
        del scan_v, scan_s
    print("kernel int8_scan", json.dumps(row), flush=True)
    rows.append(row)
    del blocks
    torch.cuda.empty_cache()
    rows.append({"case": "Int8Index.topk_body", **int8_scan_index_check()})
    print("kernel int8_scan", json.dumps(rows[-1]), flush=True)
    torch.cuda.empty_cache()
    return rows


def kernel_phase(flush: torch.Tensor) -> dict:
    table_grad, table_grad_bmajor = table_grad_phase(flush)
    out = {
        **lookup_phase(flush),
        "table_grad": table_grad,
        "table_grad_bmajor": table_grad_bmajor,
        "row_gather": row_gather_phase(flush),
        "chunk_topk": chunk_topk_phase(flush),
        "int8_scan": int8_scan_phase(flush),
        **ce_phase(flush),
        **stats_phase(flush),
        "largest_batch": largest_batch_check(),
    }
    wide = wide_phase(flush)
    out["diag_bits"] = wide.pop("diag_bits")
    for name, rows in wide.items():  # each kernel's record leads with its D = 128 case
        out[name] += rows
    return out


# -- serving phase -------------------------------------------------------------


def check_result(res, n_corpus: int, what: str) -> None:
    check(res.scores.shape == (QUERY_BATCH, TOP_K) and res.indices.shape == (QUERY_BATCH, TOP_K),
          f"{what}: result shape {res.scores.shape}")
    check(bool(np.isfinite(res.scores).all()), f"{what}: non-finite scores")
    check(bool((np.diff(res.scores, axis=1) <= 0).all()), f"{what}: scores not descending")
    check(bool(((res.indices >= 0) & (res.indices < n_corpus)).all()), f"{what}: index out of range")


def index_rows(index, rows: torch.Tensor) -> torch.Tensor:
    """An index's [n_chunks, C, ...] rows as the corpus's [N, ...]: the
    chunks laid end to end, the padding past its N rows cut."""
    return rows.reshape(-1, *rows.shape[2:])[: len(index)]


def check_exact_vs_plain_scan(res, q: torch.Tensor, corpus: torch.Tensor) -> int:
    """The exact service's answer equals a plain float32 scan: scores within
    1e-5, index sets equal except where scores tie at the k-th place.
    Returns the number of rows whose sets differ at a tie."""
    ref_s, ref_i = torch.topk(q @ corpus.T, TOP_K, dim=1)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    check(bool(np.abs(res.scores - ref_s).max() <= 1e-5),
          f"exact scores vs plain scan: max diff {np.abs(res.scores - ref_s).max()}")
    return rows_tied_at_k(res.indices, ref_i, ref_s[:, -1], q, corpus, "exact index vs plain scan")


def rows_tied_at_k(got: np.ndarray, want: np.ndarray, kth: np.ndarray, q: torch.Tensor, corpus: torch.Tensor,
                   what: str, score=None) -> int:
    """Two top-k index sets [Q, k] of one scoring must be equal except where
    scores tie at the k-th place (``kth`` [Q], the k-th score): every row in
    one set and not the other scores the k-th score within 1e-5. The scoring
    is the float32 dot of ``q`` and ``corpus`` rows, or ``score(r, rows)``.
    Returns the number of query rows whose sets differ."""
    score = score or (lambda r, rows: corpus[rows] @ q[r])
    ties = 0
    for r in range(got.shape[0]):
        diff = set(got[r].tolist()) ^ set(want[r].tolist())
        if diff:
            dots = score(r, list(diff)).cpu().numpy()
            check(bool(np.abs(dots - kth[r]).max() <= 1e-5), f"{what}: sets differ beyond a tie, query row {r}")
            ties += 1
    return ties


def calibration_check(corpus: torch.Tensor, queries: torch.Tensor) -> dict:
    """``calibrate_serving_config(CALIBRATION_TARGET)`` over a corpus on the
    card, once with the corpus there (its exact reference a device-resident
    ``BruteForceIndex``) and once from host numpy (the exact reference
    streamed in STREAM_CHUNK-row slices): both must pick the same index
    configuration, whose measured recall meets the target; the two exact
    references' top-k must be equal except at ties. Both calls are timed."""
    host = corpus.cpu().numpy()
    picks, seconds = {}, {}
    for where, corpus_emb in (("device", corpus), ("host", host)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picks[where] = autoconfig.calibrate_serving_config(CALIBRATION_TARGET, corpus_emb, queries, k=TOP_K,
                                                           device="cuda")
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
    knobs = {where: (c.index_kind, c.approx_recall, c.rescore_depth, c.rescore_dtype) for where, (c, _) in picks.items()}
    check(knobs["device"] == knobs["host"], f"calibration: device corpus picked {knobs['device']}, host {knobs['host']}")
    chosen, measured = picks["device"]
    check(chosen.index_kind == "exact" or measured[chosen.note] >= CALIBRATION_TARGET,
          f"calibration picked {chosen.note} at recall {measured.get(chosen.note)} < {CALIBRATION_TARGET}")
    exact = BruteForceIndex(corpus, device=corpus.device).search(queries, TOP_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = autoconfig._exact_topk_streamed(host, queries, TOP_K, STREAM_CHUNK, device="cuda")
    stream_s = time.perf_counter() - t0
    ties = rows_tied_at_k(streamed, exact.indices, exact.scores[:, -1], queries, corpus,
                          "streamed exact reference vs device-resident")
    return {"companies": corpus.shape[0], "queries": queries.shape[0], "k": TOP_K, "target": CALIBRATION_TARGET,
            "pick": chosen.cli_flags(), "measured_device": picks["device"][1], "measured_host": picks["host"][1],
            "device_s": seconds["device"], "host_streamed_s": seconds["host"], "exact_streamed_scan_s": stream_s,
            "stream_chunk": STREAM_CHUNK, "rows_tied_at_k": ties}


def reset_counters() -> None:
    reset_kernel_launches()


def read_counters() -> dict[str, int]:
    return kernel_launches()


def step_launches(steps: int, val_batches: int = 0) -> dict[str, int]:
    """Each kernel's launches over ``steps`` train steps and ``val_batches``
    validation batches at B <= 8192: per step K1 and K2 twice (notice and
    company), K6 and K11 once; per validation batch K1 twice, K6, K8 and the
    sweep once."""
    return {"dense_table_lookup": 2 * steps + 2 * val_batches, "dense_table_grad": 2 * steps,
            "dense_table_grad_bmajor": 0, "embedding_lookup_pallas": 0, "fused_lean_lse": steps + val_batches,
            "fused_ce_bwd": steps, "same_tile_diag": val_batches, "fused_stats_sweep": val_batches}


def check_launches(launches: dict, expected: dict, path: str) -> None:
    for name, n in expected.items():
        check(launches[name] == n, f"{path}: kernel {name} launched {launches[name]} times, expected {n}")


def fresh_train_state(work: bench.Workload, cfg: TrainConfig | None = None):
    """(model, state, optimizer) of ``cfg`` (the bench's by default) from the
    flax-distributed init seeded with SEED, on the card."""
    cfg = cfg or work.cfg
    model = build_model(work.schema, cfg).init_flax(torch.Generator().manual_seed(SEED))
    state, tx = create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device="cuda")
    return model, state, tx


def serving_phase() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products (the default), stated
    cfg = TrainConfig()
    schema = reference_shaped_schema()
    t0 = time.perf_counter()
    ds = make_synthetic_dataset(schema, n_notices=N_NOTICES, n_companies=N_COMPANIES, seed=SEED)
    data_s = time.perf_counter() - t0
    model = build_model(schema, cfg).init_weights(torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    state = FrozenState.from_model(model)
    gen = np.random.default_rng(SEED + 1)
    batches = [ds.notice_store.gather(gen.integers(0, N_NOTICES, size=QUERY_BATCH)) for _ in range(3)]
    print(f"serving: {n_params} params, {N_COMPANIES} companies, {N_NOTICES} notices "
          f"(synthetic data {data_s:.1f} s)", flush=True)

    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = RetrievalService(model, cfg, state, ds.company_store, index_kind="exact", device="cuda")
    torch.cuda.synchronize()
    exact_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8 = RetrievalService(
        model, cfg, state, ds.company_store, index_kind="int8", corpus_chunk=262_144,
        rescore_depth=400, rescore_dtype="bfloat16", device="cuda",
    )
    torch.cuda.synchronize()
    int8_build_s = time.perf_counter() - t0
    answers = []
    for b in batches:
        answers.append((exact.search(b, TOP_K), int8.search(b, TOP_K),
                        exact.search_keys(b, TOP_K), int8.search_keys(b, TOP_K)))
    torch.cuda.synchronize()
    launches = read_counters()
    print("serving main path launches", json.dumps(launches), flush=True)
    check(launches["dense_table_lookup"] > 0, "kernel dense_table_lookup was not launched on the serving path")
    check(launches["chunk_topk"] > 0, "the scan's top-k kernel was not launched on the serving path")
    check(launches["int8_scan"] > 0, "the int8 scan's product kernel was not launched on the serving path")

    # -- checks ----------------------------------------------------------------
    gather_model = build_model(
        schema, cfg.replace(model=dataclasses.replace(cfg.model, embedding_lookup="gather"))
    )
    encode_gather = make_encode_fn(gather_model, "notice")
    recalls, ties, emb_err = [], 0, 0.0
    exact_rows = index_rows(exact.index, exact.index.corpus)
    for b, (res_e, res_8, keys_e, keys_8) in zip(batches, answers):
        check_result(res_e, N_COMPANIES, "exact")
        check_result(res_8, N_COMPANIES, "int8")
        q = exact.encode_queries(b)
        ties += check_exact_vs_plain_scan(res_e, q, exact_rows)
        # int8 + bf16 rescore: returned scores are the bf16 dots of their rows
        idx = torch.from_numpy(res_8.indices).long().cuda()
        rows = int8.index.rescore_rows[idx].float()
        q8 = int8.encode_queries(b).to(torch.bfloat16).float()
        dots = (rows * q8[:, None, :]).sum(-1).cpu().numpy()
        check(bool(np.abs(dots - res_8.scores).max() <= 1e-5),
              f"int8 scores vs bf16 dots: max diff {np.abs(dots - res_8.scores).max()}")
        recalls.append(recall_vs_exact(res_8, res_e))
        check(recalls[-1] >= 0.9, f"int8 recall@{TOP_K} vs exact {recalls[-1]} < 0.9")
        keys = ds.company_store.keys
        check(keys_e[0][0][0] == str(keys[res_e.indices[0, 0]]), "exact search_keys disagree with search")
        check(keys_8[0][0][0] == str(keys[res_8.indices[0, 0]]), "int8 search_keys disagree with search")
        # the kernel path's notice embeddings equal the plain gather path's
        q_gather = encode_gather(exact.state, b.to("cuda"))
        emb_err = max(emb_err, float((q - q_gather).abs().max()))
        check(emb_err <= 1e-6, f"notice embeddings kernel vs gather path: max diff {emb_err}")
    print(f"serving checks: int8 recall@{TOP_K} vs exact {recalls}, exact rows tied at k: {ties}, "
          f"kernel vs gather embedding max diff {emb_err}", flush=True)

    # -- throughput ----------------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact._evaluator.encode_corpus(exact.state, ds.company_store.dense, ds.company_store.cat_ids)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    qps = {
        kind: qps_bench(svc, ds.notice_store, k=TOP_K, batch_size=QUERY_BATCH, n_batches=20)
        for kind, svc in (("exact", exact), ("int8", int8))
    }
    breakdown = {
        kind: device_breakdown(lambda svc=svc: svc.search(batches[0], TOP_K))
        for kind, svc in (("exact", exact), ("int8", int8))
    }
    for kind, row in breakdown.items():
        print(f"device time of one {kind} query batch " + json.dumps(row), flush=True)

    # -- the serve CLI's auto-configuration at 1M companies ------------------------
    rows = np.sort(gen.choice(N_NOTICES, size=CALIBRATION_QUERIES, replace=False))
    cal_q = exact._evaluator.encode_corpus(exact.state, ds.notice_store.dense[rows], ds.notice_store.cat_ids[rows],
                                           side="notice")
    calibration = calibration_check(exact_rows, cal_q)
    print("calibration " + json.dumps(calibration), flush=True)
    return {
        "params": n_params, "companies": N_COMPANIES, "notices": N_NOTICES,
        "launches": launches, "recall_int8_vs_exact": recalls,
        "exact_service_build_s": exact_build_s, "int8_service_build_s": int8_build_s,
        "corpus_encode_s": encode_s,
        "qps_exact": qps["exact"]["qps"], "ms_per_batch_exact": qps["exact"]["latency_ms_per_batch"],
        "qps_int8": qps["int8"]["qps"], "ms_per_batch_int8": qps["int8"]["latency_ms_per_batch"],
        "device_busy_share": {kind: row["busy_share"] for kind, row in breakdown.items()},
        "calibration": calibration,
    }


# -- training phase ---------------------------------------------------------------


TRAINING_KERNELS = ("dense_table_lookup", "dense_table_grad", "fused_lean_lse", "fused_ce_bwd")


def training_phase() -> tuple[dict, bench.Workload]:
    """The headline bench's workload on the card: one warm-up call and
    TRAIN_TIMED_CALLS timed calls of 16 steps at B=8192, the launch counters
    read around them, then a profiler breakdown of one more call. Returns
    the record and the workload, whose trained state the evaluation uses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    work = bench.build_workload(device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in work.state.params.values())
    print(f"training: {n_params} params, B={work.batch_size}, "
          f"{bench.N_NOTICES} notices x {bench.N_COMPANIES} companies, {bench.N_PAIRS} pairs "
          f"(data and upload {work.data_s:.1f} s)", flush=True)

    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = work.call(0)["loss"].cpu().numpy()
    warm_s = time.perf_counter() - t0
    out = bench.timed_calls(work, TRAIN_TIMED_CALLS)
    torch.cuda.synchronize()
    launches = read_counters()
    print("training main path launches", json.dumps(launches), flush=True)
    for name in TRAINING_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the training path")
    losses = np.asarray([first.tolist()] + out["losses"])
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(float(losses[-1].mean()) < float(losses[0].mean()),
          f"training loss did not decrease: first call {losses[0].mean()}, last {losses[-1].mean()}")
    breakdown = device_breakdown(
        lambda: work.call(10_000 + work.state.step)["loss"].cpu(), repeats=1, top=12, host_top=12
    )
    print("device time of one training call " + json.dumps(breakdown), flush=True)
    return {
        "params": n_params, "batch": work.batch_size, "steps_per_call": len(first),
        "timed_calls": TRAIN_TIMED_CALLS, "warmup_call_s": warm_s,
        "examples_per_sec": out["examples_per_sec"], "ms_per_step": out["ms_per_step"], "mfu": out["mfu"],
        "call_ms": out["call_ms"],
        "model_gflops_per_step": out["model_gflops_per_step"],
        "loss_first_call": float(losses[0].mean()), "loss_last_call": float(losses[-1].mean()),
        "launches": launches, "launches_per_step": {k: v / losses.size for k, v in launches.items()},
        "device_busy_share": breakdown["busy_share"], "device_ms_per_call": breakdown["device_ms_per_call"],
        # the profiled call's device time over the unprofiled calls' wall time
        "device_busy_share_timed": breakdown["device_ms_per_call"] / (out["ms_per_step"] * len(first)),
        "device_events_per_call": breakdown["device_events_per_call"], "host_top": breakdown["host_top"],
        "wall_ms_per_call": breakdown["wall_ms_per_call"], "top_ms": breakdown["top_ms"],
    }, work


# -- evaluation phase -------------------------------------------------------------


def held_out_pairs(ds, n: int, seed: int) -> np.ndarray:
    """n positive pairs by the synthetic generator's rule (a uniform notice,
    then a uniform company of the notice's cluster; data/synthetic.py), from
    another seed than the training pairs."""
    rng = np.random.default_rng(seed)
    by_cluster = [np.flatnonzero(ds.company_cluster == k) for k in range(bench.N_CLUSTERS)]
    counts = np.asarray([len(m) for m in by_cluster])
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
    members = np.concatenate(by_cluster)
    notices = rng.integers(0, len(ds.notice_cluster), size=n)
    cluster = ds.notice_cluster[notices]
    companies = members[offsets[cluster] + (rng.random(n) * counts[cluster]).astype(np.int64)]
    return np.stack([notices, companies], axis=1).astype(np.int64)


def eval_metric_check(ev: Evaluator, state, cfg, idx: torch.Tensor, notice_store, company_store) -> dict:
    """One eval batch: the eval step's metrics (the fused path: K6 for the
    loss, K8 + the sweep for the metrics) against ``in_batch_metrics`` and
    the materialized loss of the same embeddings, S formed from the bf16
    operands the kernels take with f32 sums. Ranks under the near-tie rule;
    the rank metrics may then differ by the share of rows whose rank
    differs; similarities within EVAL_SIM_ATOL; the loss within 1e-4."""
    b, tau = idx.shape[0], cfg.loss.temperature
    batch = PairBatch(default_tower_gather(notice_store, idx[:, 0]), default_tower_gather(company_store, idx[:, 1]))
    fused = {k: float(v) for k, v in ev._eval_step(state, batch).items()}
    n_emb, c_emb = ev._encode_notice(state, batch.notice), ev._encode_company(state, batch.company)
    n_scaled = n_emb.float() / tau
    sim = n_scaled.to(torch.bfloat16).float() @ c_emb.to(torch.bfloat16).float().T
    plain = {k: float(v) for k, v in in_batch_metrics(sim).items()}
    plain_loss = 0.5 * (torch.nn.functional.cross_entropy(sim, torch.arange(b, device=sim.device))
                        + torch.nn.functional.cross_entropy(sim.T, torch.arange(b, device=sim.device)))
    stats = fl.fused_stats(n_emb, c_emb, temperature=tau)
    gate = rank_gate(stats.rank, diagonal_ranks(sim).float(), n_scaled, c_emb, stats.diag, 0, f"eval B={b}")
    slack = gate["rank_rows_differing"] / b + 1e-6
    diffs = {k: abs(fused[k] - plain[k]) for k in plain}
    row = {"metric_abs_diff_vs_in_batch_metrics": diffs, "loss_abs_diff_vs_materialized": abs(fused["loss"] - float(plain_loss)),
           **gate, "rank_metric_tolerance": slack, "sim_tolerance": EVAL_SIM_ATOL}
    for k in ("accuracy", "mrr", "auc", "recall@5", "recall@10"):
        check(diffs[k] <= slack, f"eval B={b}: {k} fused {fused[k]} vs in_batch_metrics {plain[k]}")
    for k in ("positive_similarity", "negative_similarity", "similarity_gap"):
        check(diffs[k] <= EVAL_SIM_ATOL, f"eval B={b}: {k} fused {fused[k]} vs in_batch_metrics {plain[k]}")
    check(row["loss_abs_diff_vs_materialized"] <= 1e-4, f"eval B={b}: loss {fused['loss']} vs {float(plain_loss)}")
    return row


def evaluation_phase(work: bench.Workload) -> tuple[dict, dict]:
    """The evaluation path on the training phase's state: ``evaluate_indexed``
    over EVAL_PAIRS held-out pairs at B=8192 (path "eval": K6, K8, K5) and at
    B=16384 (path "eval_b16384": K7, K8, K9), each after one warm-up batch:
    one counted call, then EVAL_TIMED_CALLS - 1 more for the median ms per
    batch, and one batch's metrics held against in_batch_metrics; then the
    corpus eval of the held-out notices against every company. Returns the
    record and the launch counts of each path."""
    cfg, state = work.cfg, work.state
    ev = Evaluator(build_model(work.schema, cfg), cfg)
    held = held_out_pairs(work.dataset, EVAL_PAIRS, SEED + 5)
    n_companies = len(work.dataset.company_cluster)
    trained = np.isin(held[:, 0] * n_companies + held[:, 1], work.dataset.pairs[:, 0] * n_companies + work.dataset.pairs[:, 1])
    out = {"held_out_pairs": EVAL_PAIRS, "held_out_share_also_in_training": float(trained.mean()),
           "state_step": state.step}
    launches = {}
    for path, b, stack in (("eval", CE_BATCH, 4), ("eval_b16384", BLOCKED_BATCHES[0], 2)):
        ev.evaluate_indexed(state, held[:b], work.notice_store, work.company_store, batch_size=b, stack=1)
        call_ms = []

        def timed_call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = ev.evaluate_indexed(state, held, work.notice_store, work.company_store, batch_size=b, stack=stack)
            call_ms.append((time.perf_counter() - t0) * 1e3 / m["num_batches"])  # ends in the metrics' fetch
            return m

        # -- the main path: counters from 0, read right after ------------------
        reset_counters()
        m = timed_call()
        launches[path] = read_counters()
        print(f"{path} main path launches", json.dumps(launches[path]), flush=True)
        for name in ("fused_lean_lse", "same_tile_diag", "fused_stats_sweep"):
            check(launches[path][name] > 0, f"kernel {name} was not launched on the {path} path")
        check(all(np.isfinite(v) for v in m.values()), f"{path}: non-finite metric {m}")
        for _ in range(EVAL_TIMED_CALLS - 1):  # a longer window for the host-timed ms per batch
            timed_call()
        rb = random_baselines(b)
        row = {"batch": b, "num_batches": m["num_batches"], "ms_per_batch": float(np.median(call_ms)),
               "ms_per_batch_min": min(call_ms), "ms_per_batch_max": max(call_ms), "timed_calls": len(call_ms),
               "metrics": m, "random_recall@10": rb["recall@10"], "random_accuracy": rb["accuracy"],
               "assessment": qualitative_assessment(m, b),
               **eval_metric_check(ev, state, cfg, torch.from_numpy(held[:b]).cuda(), work.notice_store,
                                   work.company_store)}
        row["device_one_batch"] = device_breakdown(
            lambda: ev.evaluate_indexed(state, held[:b], work.notice_store, work.company_store, batch_size=b, stack=1),
            repeats=3, top=8,
        )
        print(f"{path} " + json.dumps(row), flush=True)
        check(m["recall@10"] > rb["recall@10"], f"{path}: in-batch recall@10 {m['recall@10']} <= random {rb['recall@10']}")
        out[path] = row

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus_emb = ev.encode_corpus_device(state, work.company_store, n_companies)
    rows = torch.from_numpy(held[:, 0]).cuda()
    query_store = (work.notice_store[0].index_select(0, rows), work.notice_store[1].index_select(0, rows))
    query_emb = ev.encode_corpus_device(state, query_store, len(held), side="notice")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = corpus_retrieval_eval(query_emb, corpus_emb, held[:, 1])
    corpus_s = time.perf_counter() - t0
    demo = demonstrate_predictions(query_emb[:2], corpus_emb, k=3, corpus_keys=work.dataset.company_store.keys)
    out["corpus"] = {"queries": res.num_queries, "corpus_size": res.corpus_size, "recall@10": res.recall[10],
                     "recall@100": res.recall[100], "mrr": res.mrr, "random_recall@100": 100 / res.corpus_size,
                     "encode_s": encode_s, "corpus_eval_s": corpus_s, "demo": demo}
    print("corpus eval " + json.dumps(out["corpus"]), flush=True)
    check(res.recall[100] > 100 / res.corpus_size,
          f"corpus recall@100 {res.recall[100]} <= random {100 / res.corpus_size}")
    return out, launches


def extra_training_phase(work: bench.Workload) -> tuple[dict, dict]:
    """One call of EXTRA_STEPS sampled train steps from a fresh state on the
    bench's stores: at B=16384 (path "train_b16384": the col-blocked CE, K7
    and K10) and at B=8192 with label smoothing 0.1 (path "train_ls0.1": the
    statistics forward K8 + K5 and K11). Every loss finite; the counters
    show each path's kernels. Returns the record and the launch counts."""
    out, launches = {}, {}
    for path, b, eps, kernels in (
        ("train_b16384", BLOCKED_BATCHES[0], 0.0, ("fused_lean_lse", "fused_ce_bwd")),
        ("train_ls0.1", CE_BATCH, 0.1, ("same_tile_diag", "fused_stats_sweep", "fused_ce_bwd")),
    ):
        cfg = work.cfg.replace(loss=dataclasses.replace(work.cfg.loss, label_smoothing=eps))
        model, state, tx = fresh_train_state(work, cfg)
        steps = make_sampled_train_steps(model, cfg, tx, EXTRA_STEPS, b)
        # -- the main path: counters from 0, read right after ----------------------
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps(state, SEED + 7, work.pairs, work.notice_store, work.company_store)
        losses = m["loss"].cpu().numpy()
        call_s = time.perf_counter() - t0
        launches[path] = read_counters()
        print(f"{path} main path launches", json.dumps(launches[path]), flush=True)
        for name in ("dense_table_lookup", "dense_table_grad") + kernels:
            check(launches[path][name] > 0, f"kernel {name} was not launched on the {path} path")
        if eps:
            check(launches[path]["fused_lean_lse"] == 0, f"{path}: label smoothing ran the lean forward")
        check(bool(np.isfinite(losses).all()), f"{path}: non-finite loss {losses}")
        out[path] = {"batch": b, "label_smoothing": eps, "steps": EXTRA_STEPS, "losses": losses.tolist(),
                     "first_call_s": call_s, "launches": launches[path]}
        print(f"{path} " + json.dumps(out[path]), flush=True)
    return out, launches


# -- the trainer: the headline run, and checkpoint/resume -------------------------


def headline_launches(cfg: TrainConfig) -> dict[str, int]:
    """The launches of each kernel on the headline run, from its shape: its
    train steps and validation batches (``step_launches``; validation after
    every epoch and once more at the end), and per epoch's corpus eval K1
    once per encode chunk of 8192 rows (the company store from the card,
    the validation notices from the host)."""
    n_val = int(round(bench.N_PAIRS * cfg.data.test_split))
    return trainer_launches(HEADLINE_EPOCHS, bench.N_PAIRS - n_val, n_val, bench.N_COMPANIES)


def trainer_launches(epochs: int, n_train: int, n_val: int, n_companies: int, batch: int = CE_BATCH) -> dict[str, int]:
    """Each kernel's launches on ``Trainer.train`` at B = ``batch`` with the
    corpus eval after every epoch: the train steps and validation batches
    (``step_launches``; validation after every epoch and once more at the
    end), and per epoch's corpus eval K1 once per encode chunk of 8192 rows
    (the company store from the card, the validation notices from the
    host)."""
    launches = step_launches(epochs * (n_train // batch), (epochs + 1) * (n_val // batch))
    launches["dense_table_lookup"] += epochs * (math.ceil(n_companies / 8192) + math.ceil(n_val / 8192))
    return launches


def headline_phase(training: dict, out_dir: Path) -> tuple[dict, dict]:
    """The headline recipe end to end through the port's CLIs:
    ``train_headline.main`` (``python -m jodalrob_twotower_torch.train`` in-process:
    ``TrainConfig()`` on the bench-scale data, B=8192, HEADLINE_EPOCHS epochs
    sampled on the card, validation and the corpus eval after every epoch,
    checkpoints), into ``out_dir``, whose ``run/`` keeps the run's checkpoints
    for the serve CLI (the caller removes the directory). Every
    epoch's losses must be finite, the run must learn and its final corpus
    recall@100 lie within 0.05 of the JAX artifact's, and each kernel must
    launch exactly as often as the run's steps, validation batches and
    encode chunks ask (``headline_launches``). Returns the record and the
    launch counts."""
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = train_headline.main(["--epochs", str(HEADLINE_EPOCHS), "--output-dir", str(out_dir),
                              "--checkpoint-dir", str(out_dir / "run")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    summary = json.loads((out_dir / "summary.json").read_text())
    print("headline main path launches", json.dumps(launches), flush=True)
    check(rc == 0, f"train_headline returned {rc}")
    leg = summary["torch"]
    epochs = leg["per_epoch"]
    check(len(epochs) == HEADLINE_EPOCHS, f"headline: {len(epochs)} epochs logged, not {HEADLINE_EPOCHS}")
    check(all(np.isfinite([e["train_loss"], e["val_loss"]]).all() for e in epochs),
          f"headline: a non-finite epoch loss {epochs}")
    check(summary["learned"], f"headline did not learn: {summary}")
    check(summary["within_tolerance"], f"headline recall@100 not within {summary['tolerance']}: {summary}")
    check_launches(launches, headline_launches(TrainConfig()), "headline")
    row = {
        "epochs": [{"epoch": int(e["epoch"]), "train_loss": e["train_loss"], "val_loss": e["val_loss"],
                    "corpus_recall@10": e["corpus_recall@10"], "corpus_recall@100": e["corpus_recall@100"],
                    "examples_per_sec": e["examples_per_sec"]} for e in epochs],
        "final_corpus_recall_at_100": leg["final_corpus_recall_at_100"],
        "final_corpus_recall_at_10": leg["final_corpus_recall_at_10"],
        "reference_recall_at_100": summary["reference"]["final_corpus_recall_at_100"],
        "recall_at_100_abs_diff": summary["recall_at_100_abs_diff"], "learned": summary["learned"],
        "within_tolerance": summary["within_tolerance"], "final_val_loss": leg["final_val_loss"],
        "examples_per_sec_last_epoch": leg["examples_per_sec"],
        "bench_examples_per_sec": training["examples_per_sec"],
        "bench_device_ms_per_step": training["device_ms_per_call"] / training["steps_per_call"],
        "train_wall_s": leg["wall_s"], "wall_s": wall_s, "launches": launches, "card": summary["card"],
    }
    print("headline " + json.dumps(row), flush=True)
    return row, {"headline": launches}


# -- the serve CLI on the headline's weights, and the step profiler ----------------


def run_cli(main, argv: list) -> tuple[str, str]:
    """``main(argv)`` in-process; returns (stdout, stderr), each also echoed."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    print(out.getvalue() + err.getvalue(), end="", flush=True)
    check(rc == 0, f"{main.__module__}.main returned {rc}")
    return out.getvalue(), err.getvalue()


def _jsonl_hits(path: Path) -> list[tuple[str, list[str]]]:
    return [(row["notice"], [h["company"] for h in row["top_k"]])
            for row in map(json.loads, path.read_text().splitlines())]


def auto_config_pick(stderr: str) -> tuple[str, dict[str, float], str]:
    """The serve CLI's ``--target-recall`` pick from its auto-config line:
    (the pick's note, each measured candidate's recall and "exact", the
    equivalent flags)."""
    (auto_line,) = [x for x in stderr.splitlines() if x.startswith("auto-config")]
    m = re.search(r": (.*) — measured recall@\d+ (.*); equivalent to (.*)$", auto_line)
    check(m is not None, f"serve CLI: no pick in {auto_line!r}")
    measured = dict(item.rsplit(": ", 1) for item in m.group(2).split(", "))
    return m.group(1), {k: float(v) for k, v in measured.items()}, m.group(3)


def serve_cli_phase(model_dir: Path) -> tuple[dict, dict]:
    """``python -m jodalrob_twotower_torch.serve`` in-process on the
    headline's trained weights (``TrainConfig()`` at full width) over the
    bench-scale data (100,000 companies), SERVE_QUERIES notices at k = 100
    in each run: the int8 index built and saved; the saved index loaded,
    whose JSONL must equal the build's line for line; the exact index; the
    int8 and exact answers each equal to a plain scan of the same embeddings
    except at ties, and the int8 recall@100 against the exact measured
    (``serve_cli_answers``); ``--target-recall``
    CALIBRATION_TARGET, whose pick's measured recall must meet it; and
    ``--qps-bench``. Each run's K1 launches must equal its corpus encode
    chunks plus its query batches exactly, the scan's top-k kernel two a
    searched block of 1,024 queries (the corpus is one step wide), the int8
    product one a block the int8 index searched (the corpus is one chunk),
    and no other kernel may launch."""
    tmp = model_dir.parent / "serve"
    tmp.mkdir()
    base = ["--model-dir", model_dir, "--synthetic", "--synthetic-scale", "bench", "--k", TOP_K]
    answer = ["--queries", SERVE_QUERIES]
    corpus_chunks = math.ceil(bench.N_COMPANIES / 8192)  # Evaluator.encode_corpus's chunk
    query_batches = math.ceil(SERVE_QUERIES / serve.QUERY_BATCH)
    topk_per_block = 2 * math.ceil(bench.N_COMPANIES / ct.WINDOW)  # the top-k kernel's launches a query block
    runs = {  # name: (argv, expected K1 launches, query blocks searched and those by the int8 index; None: the
        # calibration's, read after)
        "int8": (base + answer + ["--output", tmp / "int8.jsonl", "--save-index", tmp / "int8.npz"],
                 corpus_chunks + query_batches, query_batches, query_batches),
        "loaded": (base + answer + ["--output", tmp / "loaded.jsonl", "--load-index", tmp / "int8.npz"], query_batches,
                   query_batches, query_batches),
        "exact": (base + answer + ["--index", "exact", "--output", tmp / "exact.jsonl"], corpus_chunks + query_batches,
                  query_batches, 0),
        "target_recall": (base + answer + ["--target-recall", CALIBRATION_TARGET, "--output", tmp / "auto.jsonl"],
                          corpus_chunks + math.ceil(CALIBRATION_QUERIES / 8192) + query_batches, None, None),
        "qps_bench": (base + ["--qps-bench"], corpus_chunks + SERVE_QPS_BATCHES, SERVE_QPS_BATCHES, SERVE_QPS_BATCHES),
    }
    row, launches, streams = {}, {}, {}
    for name, (argv, k1, blocks, int8_blocks) in runs.items():
        # -- the main path: counters from 0, read right after ------------------
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams[name] = run_cli(serve.main, argv)
        torch.cuda.synchronize()
        row[f"{name}_wall_s"] = time.perf_counter() - t0
        launches[f"serve_cli_{name}"] = got = read_counters()
        print(f"serve_cli_{name} main path launches", json.dumps(got), flush=True)
        if blocks is None:  # each index the calibration searched with its sample, then the answers
            note, measured, _ = auto_config_pick(streams[name][1])
            candidates = len(measured) - 1  # the int8 candidates measured
            searches = candidates + ("moved to the host" not in streams[name][1])  # the exact reference, unless streamed
            sample_blocks = math.ceil(CALIBRATION_QUERIES / serve.QUERY_BATCH)
            blocks = searches * sample_blocks + query_batches
            int8_blocks = candidates * sample_blocks + (query_batches if note != autoconfig.EXACT.note else 0)
        want = {c: 0 for c in got} | {"dense_table_lookup": k1, "chunk_topk": topk_per_block * blocks,
                                      "int8_scan": int8_blocks}
        check(got == want, f"serve CLI {name}: launches {got}, expected {want}")
    check((tmp / "int8.jsonl").read_text() == (tmp / "loaded.jsonl").read_text(),
          "serve CLI: the loaded index's JSONL differs from the built index's")
    int8, exact = _jsonl_hits(tmp / "int8.jsonl"), _jsonl_hits(tmp / "exact.jsonl")
    check(len(int8) == len(exact) == SERVE_QUERIES and all(a[0] == b[0] for a, b in zip(int8, exact)),
          "serve CLI: the int8 and exact runs answered different notices")
    row.update(serve_cli_answers(model_dir, int8, exact))
    note, measured, row["target_recall_pick"] = auto_config_pick(streams["target_recall"][1])
    row["target_recall_measured"] = measured
    check(note == "exact brute-force f32 scan" or float(measured[note]) >= CALIBRATION_TARGET,
          f"serve CLI: --target-recall {CALIBRATION_TARGET} picked {note} at recall {measured.get(note)}")
    qps = json.loads([x for x in streams["qps_bench"][0].splitlines() if x.startswith('{"bench"')][-1])
    check(qps["bench"] == "serve_cli_qps" and qps["qps"] > 0 and qps["corpus_size"] == bench.N_COMPANIES,
          f"serve CLI: qps line {qps}")
    row.update({"companies": bench.N_COMPANIES, "queries": SERVE_QUERIES, "k": TOP_K, "qps": qps["qps"],
                "ms_per_batch": qps["latency_ms_per_batch"], "qps_batch": qps["batch_size"],
                "launches": launches})
    print("serve_cli " + json.dumps(row), flush=True)
    return row, launches


def serve_cli_answers(model_dir: Path, int8: list[tuple[str, list[str]]], exact: list[tuple[str, list[str]]]) -> dict:
    """The serve CLI's int8 and exact answers (notice, company keys) against
    plain scans of the same embeddings, encoded again from ``model_dir`` as
    the CLI encodes them (the corpus in chunks of 8192, the notices in
    batches of QUERY_BATCH): each must equal its plain scan except at ties
    (``rows_tied_at_k``): the exact one a float32 product, the int8 one the
    reference's int8 scoring (host ``quantize_int8``, which the card's must
    equal bit for bit; bf16-rounded queries, float32 sums, the row scale).
    Returns the int8 recall@k against the exact
    scan as set overlap and with ties counted (a returned company is a hit
    when its exact score reaches the exact k-th within 1e-5), and the rows
    tied at k. The trained towers put companies of one planted cluster (up
    to 255 share their categorical ids; a company has one numeric feature)
    within about 1e-3 of each other in score, where int8's scoring error
    lies, so that recall measures the data as much as the index."""
    from jodalrob_twotower_torch.train.cli import synthetic_data

    cfg = TrainConfig.from_json(model_dir / "config.json")
    schema, notice_store, company_store, _ = synthetic_data("bench", cfg.seed)
    model = build_model(schema, cfg)
    weights = CheckpointManager(model_dir, cfg.checkpoint).restore_weights(model.state_dict(), device="cuda")
    state = FrozenState({**weights["params"], **weights["batch_stats"]})
    ev = Evaluator(model, cfg)
    corpus = ev.encode_corpus(state, company_store.dense, company_store.cat_ids)
    rows = notice_store.rows_for_keys([notice for notice, _ in exact])
    # in the CLI's query batches: another batch size may round the bf16 towers' products otherwise
    q = torch.cat([ev._encode_notice(state, notice_store.gather(rows[lo : lo + serve.QUERY_BATCH]).to(corpus.device))
                   for lo in range(0, len(rows), serve.QUERY_BATCH)])
    values, scales = (torch.from_numpy(a).to(corpus.device) for a in quantize_int8(corpus.cpu().numpy()))
    on_card = quantize_int8(corpus)
    check(torch.equal(on_card[0], values) and torch.equal(on_card[1], scales),
          "quantize_int8 on the card differs from the host's bits")

    def int8_scores(qb, cols=None):
        v, sc = (values, scales[:, 0]) if cols is None else (values[cols], scales[cols, 0])
        return (qb.to(torch.bfloat16).float() @ v.float().T) * sc

    def keys(hits):
        return torch.from_numpy(np.stack([company_store.rows_for_keys(c) for _, c in hits])).to(corpus.device)

    got8, got_exact = keys(int8), keys(exact)
    k = got8.shape[1]
    out = {"int8_rows_tied_vs_plain": 0, "exact_rows_tied_vs_plain": 0}
    n_hits = 0
    for lo in range(0, len(exact), QUERY_BATCH):
        qb, g8, ge = q[lo : lo + QUERY_BATCH], got8[lo : lo + QUERY_BATCH], got_exact[lo : lo + QUERY_BATCH]
        e_s, e_i = torch.topk(qb @ corpus.T, k, dim=1)
        i_s, i_i = torch.topk(int8_scores(qb), k, dim=1)
        out["exact_rows_tied_vs_plain"] += rows_tied_at_k(
            ge.cpu().numpy(), e_i.cpu().numpy(), e_s[:, -1].cpu().numpy(), qb, corpus, "serve CLI exact vs plain scan")
        out["int8_rows_tied_vs_plain"] += rows_tied_at_k(
            g8.cpu().numpy(), i_i.cpu().numpy(), i_s[:, -1].cpu().numpy(), qb, corpus, "serve CLI int8 vs plain int8 scan",
            score=lambda r, cols, qb=qb: int8_scores(qb[r : r + 1], cols)[0])
        n_hits += int((torch.bmm(corpus[g8], qb[:, :, None])[..., 0] >= e_s[:, -1:] - 1e-5).sum())
    out["int8_recall_at_100_vs_exact"] = sum(len(set(a[1]) & set(b[1])) for a, b in zip(int8, exact)) / got8.numel()
    out["int8_recall_at_100_ties_counted"] = n_hits / got8.numel()
    return out


# -- the host-fed input pipeline and the streaming trainer -------------------------


def hostfed_index_phase(work: bench.Workload) -> tuple[dict, dict]:
    """Host-fed index streaming (``bench_suite.py`` ``train_hostfed``'s
    workload): ``index_stacks(pairs, 8192, 16, seed=epoch, prefetch=2)``
    windows, epoch after epoch, through ``make_scanned_train_steps`` over
    the bench's stores on the card, HOSTFED_STEPS steps after one warm-up
    window. Beside it, in turns: the device-sampled bench's timed calls
    (before and after), and the same steps on the same windows uploaded
    before the clock starts (what the steps cost without the pipeline).
    Launches exact per step. Returns the record and the counts."""
    model, state, tx = fresh_train_state(work)
    steps = make_scanned_train_steps(model, work.cfg, tx, HOSTFED_N_INNER)
    pairs = work.dataset.pairs
    n_windows = HOSTFED_STEPS // HOSTFED_N_INNER

    def streamed_windows():
        epoch = 0
        while True:
            yield from index_stacks(pairs, CE_BATCH, HOSTFED_N_INNER, seed=epoch, prefetch=HOSTFED_PREFETCH,
                                    device="cuda")
            epoch += 1

    def run(windows) -> tuple[np.ndarray, float]:
        nonlocal state
        torch.cuda.synchronize()
        losses = []
        t0 = time.perf_counter()
        for stack in windows:
            state, m = steps(state, stack, work.notice_store, work.company_store)
            losses.append(m["loss"])
        losses = torch.cat(losses).cpu().numpy()  # ends in the losses' fetch
        return losses, time.perf_counter() - t0

    run(itertools.islice(streamed_windows(), 1))  # warm-up
    sampled_before = bench.timed_calls(work, TRAIN_TIMED_CALLS, first_seed=100)
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    losses, elapsed = run(itertools.islice(streamed_windows(), n_windows))
    launches = read_counters()
    print("hostfed_index main path launches", json.dumps(launches), flush=True)
    resident = list(itertools.islice(streamed_windows(), n_windows))
    _, resident_s = run(resident)
    sampled_after = bench.timed_calls(work, TRAIN_TIMED_CALLS, first_seed=200)
    done = losses.size
    check(done == HOSTFED_STEPS, f"hostfed_index ran {done} steps, not {HOSTFED_STEPS}")
    check_launches(launches, step_launches(done), "hostfed_index")
    check(bool(np.isfinite(losses).all()), f"hostfed_index: non-finite loss {losses}")
    row = {"batch": CE_BATCH, "n_inner": HOSTFED_N_INNER, "prefetch": HOSTFED_PREFETCH, "steps": done,
           "examples_per_sec": done * CE_BATCH / elapsed, "ms_per_step": elapsed / done * 1e3,
           "resident_windows_ms_per_step": resident_s / done * 1e3,
           "loss_first": float(losses[:HOSTFED_N_INNER].mean()), "loss_last": float(losses[-HOSTFED_N_INNER:].mean()),
           "sampled_examples_per_sec": [sampled_before["examples_per_sec"], sampled_after["examples_per_sec"]],
           "sampled_ms_per_step": [sampled_before["ms_per_step"], sampled_after["ms_per_step"]],
           "launches": launches}
    print("hostfed_index " + json.dumps(row), flush=True)
    return row, {"hostfed_index": launches}


def hostfed_features_phase(work: bench.Workload) -> tuple[dict, dict]:
    """The whole host feature pipeline (``bench_suite.py``
    ``train_hostfed_features``'s workload): ``train_batches(background=True,
    prefetch=2)``, i.e. ``BackgroundAssembler`` gathering the rows of each
    B=8192 batch into page-locked memory on a worker thread and
    ``prefetch_to_device`` copying them on a side stream, through
    ``make_train_step``, HOSTFED_FEATURE_BATCHES batches after a warm-up
    step; examples/s, MB per step, the effective host-to-device MB/s and the
    consumer's wait for each batch (the time ``next`` takes). Beside it, in
    one call: the same steps with the gather on the consumer's thread
    (``background=False, prefetch=2``), and on the same batches already on
    the card (the step without the feed). Then the race
    check: RACE_CHECK_BATCHES batches through this path and the same batches
    through ``background=False, prefetch=0`` (plain blocking copies on the
    consumer's stream), from copies of one state: every loss, parameter,
    moment and statistic must be equal bit for bit (dropout is keyed by
    (seed, step) and the kernels are bit-equal across calls, so a difference
    is a copy that raced its step). Returns the record and the counts."""
    model, state, tx = fresh_train_state(work)
    step = make_train_step(model, work.cfg, tx)
    notice, company, pairs = work.dataset.notice_store, work.dataset.company_store, work.dataset.pairs
    warm = next(train_batches(notice, company, pairs, CE_BATCH, seed=10_000, prefetch=0, background=False,
                              device="cuda"))
    state, m = step(state, warm)
    m["loss"].cpu()
    batch_bytes = sum(t.numel() * t.element_size() for side in warm for t in side if t is not None)
    pinned = [torch.empty_like(t, device="cpu", pin_memory=True).copy_(t) for side in warm for t in side
              if t is not None]

    def copy_once():
        for t in pinned:
            t.to("cuda", non_blocking=True)

    copy_ms = median_ms(copy_once, torch.empty(64 << 20, dtype=torch.uint8, device="cuda"), runs=10)

    def run(batches) -> tuple[np.ndarray, float, list[float]]:
        """HOSTFED_FEATURE_BATCHES steps on ``batches``: the losses, the
        seconds (ending in the losses' fetch) and each ``next``'s ms."""
        nonlocal state
        it = iter(batches)
        torch.cuda.synchronize()
        waits, losses = [], []
        t0 = time.perf_counter()
        for _ in range(HOSTFED_FEATURE_BATCHES):
            tw = time.perf_counter()
            batch = next(it)
            waits.append((time.perf_counter() - tw) * 1e3)
            state, m = step(state, batch)
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu().numpy()
        return losses, time.perf_counter() - t0, waits

    def feed(background: bool, prefetch: int, seed: int = 1):
        return train_batches(notice, company, pairs, CE_BATCH, seed=seed, prefetch=prefetch, background=background,
                             device="cuda")

    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    batches = feed(True, HOSTFED_PREFETCH)
    losses, elapsed, waits = run(batches)
    batches.close()
    launches = read_counters()
    print("hostfed_features main path launches", json.dumps(launches), flush=True)
    check_launches(launches, step_launches(HOSTFED_FEATURE_BATCHES), "hostfed_features")
    check(bool(np.isfinite(losses).all()), f"hostfed_features: non-finite loss {losses}")
    batches = feed(False, HOSTFED_PREFETCH)
    _, inline_s, inline_waits = run(batches)
    batches.close()
    resident = list(itertools.islice(feed(False, 0), HOSTFED_FEATURE_BATCHES))
    _, resident_s, _ = run(resident)
    del resident

    # the race check: the prefetched path against plain copies, from one state
    arms = {}
    for arm, background, prefetch in (("prefetched", True, HOSTFED_PREFETCH), ("plain", False, 0)):
        arm_state = copy.deepcopy(state)
        arm_losses = []
        arm_feed = feed(background, prefetch, seed=2)
        for _, batch in zip(range(RACE_CHECK_BATCHES), arm_feed):
            arm_state, m = step(arm_state, batch)
            arm_losses.append(m["loss"])
        arm_feed.close()
        arms[arm] = (arm_state, torch.stack(arm_losses).cpu())
    differ = _payload_differences(arms["prefetched"][0], arms["plain"][0])
    losses_equal = bool(torch.equal(arms["prefetched"][1], arms["plain"][1]))
    check(losses_equal and not differ,
          f"hostfed_features race check: losses equal {losses_equal}, leaves differing {differ}")

    step_s = elapsed / HOSTFED_FEATURE_BATCHES
    row = {"batch": CE_BATCH, "prefetch": HOSTFED_PREFETCH, "background": True, "batches": HOSTFED_FEATURE_BATCHES,
           "examples_per_sec": CE_BATCH / step_s, "ms_per_step": step_s * 1e3,
           "inline_gather_ms_per_step": inline_s / HOSTFED_FEATURE_BATCHES * 1e3,
           "inline_gather_wait_ms_median": float(np.median(inline_waits[1:])),
           "resident_batches_ms_per_step": resident_s / HOSTFED_FEATURE_BATCHES * 1e3, "mb_per_step": batch_bytes / 1e6,
           "effective_h2d_mb_per_s": batch_bytes / 1e6 / step_s,
           "one_batch_copy_ms": copy_ms, "pinned_copy_mb_per_s": batch_bytes / 1e6 / (copy_ms / 1e3),
           "consumer_wait_ms": {"first": waits[0], "median": float(np.median(waits)),
                                "median_after_first": float(np.median(waits[1:])), "max_after_first": max(waits[1:]),
                                "all": waits},
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "race_check": {"batches": RACE_CHECK_BATCHES, "losses_equal": losses_equal, "leaves_differing": differ,
                          "losses": arms["plain"][1].tolist()},
           "launches": launches}
    print("hostfed_features " + json.dumps(row), flush=True)
    return row, {"hostfed_features": launches}


def streaming_trainer_phase(work: bench.Workload) -> tuple[dict, dict]:
    """``Trainer.train`` fed by a batch source, as ``train_streaming`` feeds
    it, at B=8192 on the bench's data: the training pairs of the CLI's split
    in STREAM_CHUNKS consecutive in-memory chunks (the chunks
    ``stream_pair_chunks`` would read from a file of them; the card machine
    has no pyarrow) through ``streaming_index_batches``, seeded per epoch,
    for STREAM_EPOCHS epochs, validating after each and at the end (no
    corpus eval). Every epoch must run the steps its stream yields, the
    losses be finite and fall, and the kernels launch exactly as often as
    those steps and the validation batches ask. Returns the record and the
    counts."""
    cfg = work.cfg.replace(
        data=dataclasses.replace(work.cfg.data, batch_size=CE_BATCH),
        optimizer=dataclasses.replace(work.cfg.optimizer, num_epochs=STREAM_EPOCHS), results_csv="")
    train_pairs, val_pairs = split_pairs(work.dataset.pairs, cfg)
    chunks = np.array_split(train_pairs, STREAM_CHUNKS)
    yielded: list[int] = []

    def source(epoch: int):
        yielded.append(0)
        for idx in streaming_index_batches(iter(chunks), CE_BATCH, seed=cfg.data.shuffle_seed + epoch):
            yielded[-1] += 1
            yield idx

    steps_per_epoch = len(train_pairs) // CE_BATCH
    logs: list[str] = []
    trainer = Trainer(cfg, work.schema, work.dataset.notice_store, work.dataset.company_store, device="cuda",
                      log_fn=logs.append)
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(np.empty((0, 2), np.int64), val_pairs, batch_source=source,
                        steps_per_epoch=steps_per_epoch, corpus_eval=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    print("streaming_trainer main path launches", json.dumps(launches), flush=True)
    print("\n".join(logs), flush=True)
    val_batches = (STREAM_EPOCHS + 1) * (len(val_pairs) // CE_BATCH)
    check(yielded == [steps_per_epoch] * STREAM_EPOCHS and res.state.step == sum(yielded),
          f"streaming_trainer: the streams yielded {yielded} batches, the trainer ran {res.state.step} steps")
    check_launches(launches, step_launches(sum(yielded), val_batches), "streaming_trainer")
    train_losses = [h["train_loss"] for h in res.history]
    val_losses = [h["val_loss"] for h in res.history]
    check(bool(np.isfinite(train_losses + val_losses).all()), f"streaming_trainer: non-finite loss {res.history}")
    check(train_losses[-1] < train_losses[0] and val_losses[-1] < val_losses[0],
          f"streaming_trainer: losses did not fall: train {train_losses}, val {val_losses}")
    row = {"batch": CE_BATCH, "epochs": STREAM_EPOCHS, "chunks": [len(c) for c in chunks],
           "batches_yielded": yielded, "steps": res.state.step, "val_batches": val_batches,
           "train_loss": train_losses, "val_loss": val_losses,
           "examples_per_sec": [h["examples_per_sec"] for h in res.history], "wall_s": wall_s,
           "launches": launches}
    print("streaming_trainer " + json.dumps(row), flush=True)
    return row, {"streaming_trainer": launches}


def hostfed_phase(work: bench.Workload) -> tuple[dict, dict]:
    """The host-fed phase: index streaming, the feature pipeline with its
    race check, and the streaming trainer, one after the other."""
    out, launches = {}, {}
    t0 = time.perf_counter()
    for name, phase in (("index", hostfed_index_phase), ("features", hostfed_features_phase),
                        ("streaming_trainer", streaming_trainer_phase)):
        out[name], counts = phase(work)
        launches.update(counts)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out, launches


def profile_phase(work: bench.Workload) -> tuple[dict, dict]:
    """``profile_step``'s variants at B=8192 over the bench's stores and
    pairs (16 steps a dispatch, one warm-up and PROFILE_DISPATCHES timed
    dispatches): every ms/step finite and each kernel's launches exactly the
    variant's per-step count (PROFILE_VARIANTS: the variants that bypass a
    kernel launch it never); then ``run_trace`` over 3 dispatches of
    ``full``, whose busy share must lie in (0, 1]."""
    data = (work.schema, work.notice_store, work.company_store, work.pairs)
    dev = torch.device("cuda")
    base = profile_step.setup_state(profile_step.build(), work.schema, dev)
    rows, launches = {}, {}
    for name, per_step in PROFILE_VARIANTS.items():
        fn, state = profile_step.prepare(name, work.schema, dev, base)
        # -- the main path: counters from 0, read right after ------------------
        reset_counters()
        torch.cuda.synchronize()
        rows[name] = profile_step.timeit(name, fn, state, data, n_dispatch=PROFILE_DISPATCHES)
        torch.cuda.synchronize()
        launches[f"profile_{name}"] = got = read_counters()
        steps = rows[name]["steps"]
        want = {c: 0 for c in got} | {k: n * steps for k, n in zip(TRAINING_KERNELS, per_step)}
        check(got == want, f"profile_step {name}: launches {got}, expected {want} ({steps} steps)")
        check(math.isfinite(rows[name]["ms_per_step"]) and math.isfinite(rows[name]["probe"]),
              f"profile_step {name}: {rows[name]}")
        del fn, state
    parts = profile_step.attribute(rows)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        reset_counters()
        table = profile_step.run_trace(device=dev, data=data, n_dispatch=3, top=12, log_dir=tmp)
        torch.cuda.synchronize()
        launches["profile_trace"] = read_counters()
        trace_mb = (tmp / "trace.json").stat().st_size / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(table["busy_share"] is not None and 0.0 < table["busy_share"] <= 1.0,
          f"profile_step trace: busy share {table['busy_share']}")
    # the measured matmul peak at utils/profiling's default n = 2048 and at 8192, TFLOP/s
    peak = {dt: {f"n{n}": device_flops_estimate(dtype=dt, n=n, device="cuda") / 1e12 for n in (2048, 8192)}
            for dt in ("bfloat16", "float32")}
    row = {"batch": profile_step.B, "steps_per_dispatch": profile_step.N_INNER, "dispatches": PROFILE_DISPATCHES,
           "ms_per_step": {k: v["ms_per_step"] for k, v in rows.items()}, "attribution_ms_per_step": parts,
           "trace": {k: table[k] for k in ("busy_share", "device_ms_per_call", "wall_ms_per_call",
                                           "device_events_per_call", "top_ms")},
           "trace_file_mb": trace_mb, "matmul_peak_tflops": peak, "launches": launches}
    print("profile " + json.dumps(row), flush=True)
    return row, launches


def _payload_differences(a, b) -> list[str]:
    """The keys of two train states' checkpoint payloads whose values are
    not equal bit for bit (tensors compared on the CPU)."""
    def flat(payload, prefix=""):
        out = {}
        for k, v in payload.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
        return out

    fa, fb = flat(state_payload(a)), flat(state_payload(b))
    if set(fa) != set(fb):
        return sorted(set(fa) ^ set(fb))
    return [k for k, v in fa.items() if not (
        torch.equal(v.cpu(), fb[k].cpu()) and v.dtype == fb[k].dtype if isinstance(v, torch.Tensor) else v == fb[k])]


def resume_phase(work: bench.Workload) -> tuple[dict, dict]:
    """Checkpoint and exact resume on the card, on the headline's config
    (``TrainConfig()``: dropout 0.1, sampled batches, dense tables) at
    B=8192 over the bench's stores: RESUME_STEPS steps, ``save_step``, a
    restore into a state freshly built from other weights, RESUME_STEPS more
    steps; every param, moment, BatchNorm statistic, the step and the
    optimizer count must equal those of 2 x RESUME_STEPS uninterrupted steps
    bit for bit. The card's checkpoint restores onto the CPU and the CPU's
    back onto the card, both bit for bit. Then ``finalize``,
    ``restore_weights`` -> FrozenState -> ``RetrievalService`` over the 100,000
    companies: its search of RESUME_QUERIES notices must equal the search
    with the in-memory weights. Returns the record and the launch counts of
    the training it ran."""
    cfg, schema = work.cfg, work.schema

    def fresh(seed: int, device: str = "cuda"):
        model = build_model(schema, cfg).init_flax(torch.Generator().manual_seed(seed))
        state, tx = create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device=device)
        return model, state, make_sampled_train_steps(model, cfg, tx, RESUME_STEPS, CE_BATCH)

    def call(steps, state):
        return steps(state, SEED + 11, work.pairs, work.notice_store, work.company_store)[0]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        reset_counters()
        model, straight, steps = fresh(SEED)
        straight = call(steps, call(steps, straight))
        _, first, steps = fresh(SEED)
        first = call(steps, first)
        card_ckpt = CheckpointManager(tmp / "card")
        card_ckpt.save_step(first, 0, RESUME_STEPS)
        _, target, steps = fresh(SEED + 1)  # other weights: all must come from the file
        restored, _, saved_step, _ = card_ckpt.restore_step(target)
        resumed = call(steps, restored)
        torch.cuda.synchronize()
        launches = read_counters()
        differ = _payload_differences(resumed, straight)
        print("resume main path launches", json.dumps(launches), flush=True)
        for name in TRAINING_KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched on the resume path")
        check(saved_step == RESUME_STEPS and resumed.step == straight.step == 2 * RESUME_STEPS,
              f"resume: steps {saved_step}, {resumed.step}, {straight.step}")
        check(not differ, f"resume on the card differs from uninterrupted training in {differ}")

        # across devices: the card's checkpoint onto the CPU, the CPU's onto the card
        card_ckpt.save_step(resumed, 0, 2 * RESUME_STEPS)
        on_cpu = card_ckpt.restore_step(fresh(SEED + 2, "cpu")[1])[0]
        cpu_ckpt = CheckpointManager(tmp / "cpu")
        cpu_ckpt.save_step(on_cpu, 0, 2 * RESUME_STEPS)
        back = cpu_ckpt.restore_step(fresh(SEED + 2)[1])[0]
        check(on_cpu.device.type == "cpu" and back.device.type == "cuda", "restores landed on the wrong device")
        cross = {"card_to_cpu": _payload_differences(on_cpu, resumed), "cpu_to_card": _payload_differences(back, resumed)}
        check(not any(cross.values()), f"cross-device restore differs: {cross}")

        # the serving entry point: weights/ -> FrozenState -> RetrievalService
        card_ckpt.finalize(resumed)
        weights = card_ckpt.restore_weights(model.state_dict(), device="cuda")
        restored_state = FrozenState({**weights["params"], **weights["batch_stats"]})
        queries = work.dataset.notice_store.gather(np.arange(RESUME_QUERIES))
        results = [
            RetrievalService(model, cfg, st, work.dataset.company_store, index_kind="exact", device="cuda")
            .search(queries, TOP_K)
            for st in (restored_state, FrozenState(resumed.state_dict))
        ]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_search = bool(np.array_equal(results[0].indices, results[1].indices)
                       and np.array_equal(results[0].scores, results[1].scores))
    check(same_search, "search with the restored weights differs from the in-memory weights' search")
    # the device time of the dispatch the trainer makes on the headline path:
    # one call of RESUME_STEPS (= the trainer's n_inner) sampled steps
    breakdown = device_breakdown(lambda: steps(resumed, SEED + 11, work.pairs, work.notice_store,
                                               work.company_store)[1]["loss"].cpu(), repeats=3, top=6)
    print("device time of one trainer call " + json.dumps(breakdown), flush=True)
    row = {"steps": 2 * RESUME_STEPS, "batch": CE_BATCH, "dropout": cfg.model.dropout_rate,
           "leaves_compared": len(state_payload(straight)["params"]) + len(state_payload(straight)["batch_stats"]),
           "leaves_differing": differ, "cross_device_differing": cross, "search_equal": same_search,
           "search_queries": RESUME_QUERIES, "launches": launches,
           "trainer_call_device_ms": breakdown["device_ms_per_call"],
           "trainer_call_wall_ms": breakdown["wall_ms_per_call"], "trainer_call_busy_share": breakdown["busy_share"]}
    print("resume " + json.dumps(row), flush=True)
    return row, {"resume": launches}


# -- the offline ETL from raw tables to a trained, serving model -------------------

# The migration workflow of scripts/reference_scale_demo.py (metadata ->
# schema -> raw tables -> ETL -> training) at the bench's width: the
# reference-shaped notice (29 numeric, 32 categorical, the 768-float title)
# and company (1 numeric, 6 categorical) tables, 100,000 rows each and
# 400,000 positive pairs within 256 planted clusters. Every categorical
# column has 990 values, each observed, so each vocab fits to 993 ids, 1,003
# rows with the margin and 1,024 once aligned: the notice table is K1's
# timed [32768, 32].
ETL_NOTICES = 100_000
ETL_COMPANIES = 100_000
ETL_PAIRS = 400_000
ETL_CLUSTERS = 256
ETL_CATEGORIES = 990
ETL_NULL_EVERY = 37  # every 37th row of every column is null
ETL_CHUNK_ROWS = 25_000  # the transform's chunks (the fit sees the whole table)
ETL_TEXT_DIM = 768
ETL_TEXT_WORDS = 200  # a title is "공고 c<cluster> w<word>", the word uniform
# numeric columns: cluster centroids shared by both tables, plus noise. At a
# noise of 0.3 two epochs learned far less on the card (corpus recall@100
# under 0.01), as did columns that were a multiple of the cluster number.
ETL_CENTROID_DIM, ETL_NUMERIC_NOISE = 8, 1.0
ETL_OWN_SHARE = 0.5  # a categorical value is its cluster's with this probability, else uniform
ETL_EPOCHS = 2
ETL_SERVE_QUERIES = 8192
ETL_TFRECORD_NOTICES = 2_000
ETL_CODEC_ROWS = 20_000  # company rows written both ways by etl_codec_check
ETL_RECALL_FLOOR = 0.01  # 10x the 0.001 of random at 100 of 100,000
ETL_CRC_BYTES = 1 << 20


def etl_metadata_csv(path: Path, n_notice_numeric: int = 29, n_notice_categorical: int = 32,
                     n_company_categorical: int = 6, n_categories: int = ETL_CATEGORIES) -> Path:
    """A reference-format ``metadata.csv`` (the Korean headers) of the
    notice and company tables: PKs, ``numeric`` columns, ``character
    varying`` categoricals with their category count, the notice title as
    ``text``, and one unused column each."""
    rows = ["테이블명,컬럼명,타입,사용 여부,PK,범주형 여부,범주 갯수",
            "notice,bidntceno,character varying(40),Y,Y,,", "notice,bidntceord,character varying(3),Y,Y,,"]
    rows += [f"notice,num_{i},numeric,Y,,," for i in range(n_notice_numeric)]
    rows += [f"notice,cat_{i},character varying(100),Y,,Y,{n_categories}" for i in range(n_notice_categorical)]
    rows += ["notice,bidntcenm,text,Y,,,", "notice,rgstdt,timestamp,N,,,",
             "company,bizno,character varying(10),Y,Y,,", "company,num_0,numeric,Y,,,"]
    rows += [f"company,cat_{i},character varying(100),Y,,Y,{n_categories}" for i in range(n_company_categorical)]
    rows += ["company,opbizdt,timestamp,N,,,"]
    path.write_text("\n".join(rows) + "\n", encoding="utf-8")
    return path


def etl_raw_table(cls: dict, n: int, cluster: np.ndarray, centroids: np.ndarray, rng: np.random.Generator,
                  n_categories: int) -> dict:
    """One raw table of ``n`` rows for the classified columns ``cls``, with
    the planted cluster structure: numeric column j the cluster's centroid
    coordinate j (cycled over ``centroids``' width, the centroids shared by
    both tables) plus noise, each categorical value its cluster's with
    probability ETL_OWN_SHARE and else uniform over the column's ``n_categories``
    values (strings), titles sharing their cluster's token; every
    ETL_NULL_EVERY-th row null in every column."""
    table = {}
    if len(cls["pk"]) == 2:
        table[cls["pk"][0]] = np.asarray([f"N{i:08d}" for i in range(n)], object)
        table[cls["pk"][1]] = np.asarray(["000"] * n, object)
    else:
        table[cls["pk"][0]] = np.asarray([f"{i:010d}" for i in range(n)], object)
    for j, col in enumerate(cls["numeric"]):
        x = centroids[cluster, j % centroids.shape[1]] + rng.normal(0.0, ETL_NUMERIC_NOISE, n)
        x[::ETL_NULL_EVERY] = np.nan
        table[col] = x
    names = np.asarray([f"v{v:03d}" for v in range(n_categories)], object)
    for j, (col, _) in enumerate(cls["categorical"]):
        own = (np.arange(len(centroids)) * 131 + j * 17) % n_categories
        v = np.where(rng.random(n) < ETL_OWN_SHARE, own[cluster], rng.integers(0, n_categories, n))
        values = names[v]
        values[::ETL_NULL_EVERY] = None
        table[col] = values
    for col in cls["text"]:
        words = rng.integers(0, ETL_TEXT_WORDS, n)
        titles = np.asarray([f"공고 c{c} w{w}" for c, w in zip(cluster.tolist(), words.tolist())], object)
        titles[::ETL_NULL_EVERY] = None
        table[col] = titles
    return table


def etl_raw_tables(metadata: Path, n_notices: int, n_companies: int, n_pairs: int, seed: int = SEED,
                   n_categories: int = ETL_CATEGORIES, n_clusters: int = ETL_CLUSTERS):
    """(notice table, company table, pairs [n_pairs, 2]) from seed: each
    pair a uniform notice and a uniform company of its cluster."""
    rng = np.random.default_rng(seed)
    n_cluster = rng.integers(0, n_clusters, n_notices)
    c_cluster = rng.integers(0, n_clusters, n_companies)
    centroids = rng.normal(0.0, 1.0, (n_clusters, ETL_CENTROID_DIM))
    notice = etl_raw_table(classify_columns("notice", metadata), n_notices, n_cluster, centroids, rng, n_categories)
    company = etl_raw_table(classify_columns("company", metadata), n_companies, c_cluster, centroids, rng,
                            n_categories)
    order = np.argsort(c_cluster, kind="stable")
    starts = np.searchsorted(c_cluster[order], np.arange(n_clusters))
    counts = np.bincount(c_cluster, minlength=n_clusters)
    notices = rng.integers(0, n_notices, n_pairs)
    cl = n_cluster[notices]
    check(bool((counts[cl] > 0).all()), "etl: a paired cluster has no company")
    companies = order[starts[cl] + (rng.random(n_pairs) * counts[cl]).astype(np.int64)]
    return notice, company, np.stack([notices, companies], axis=1).astype(np.int64)


def etl_side(name: str, table: dict, metadata: Path, chunk_rows: int, embedder):
    """One table through the ETL that ``run_pipeline`` composes, in memory
    (the fit on the whole table, the transform in chunks of ``chunk_rows``;
    only the parquet files are left out): (side schema from the manifest
    dict, FeatureStore from the shared assembly, manifest, preprocessed
    columns, seconds)."""
    cls = classify_columns(name, metadata)
    n = len(table[cls["pk"][0]])
    chunks = ({k: v[lo : lo + chunk_rows] for k, v in table.items()} for lo in range(0, n, chunk_rows))
    t0 = time.perf_counter()
    manifest, columns = preprocess_in_memory(
        name, chunks, fit_table=table, pk_columns=cls["pk"], numeric_columns=cls["numeric"],
        categorical_columns=[c for c, _ in cls["categorical"]], text_columns=cls["text"] or None,
        text_embedder=embedder)
    side = side_schema_from_manifest_dict(manifest)
    store = feature_store_from_columns(side, columns)
    return side, store, manifest, columns, time.perf_counter() - t0


def etl_stores(metadata: Path, n_notices: int, n_companies: int, n_pairs: int, *, chunk_rows: int = ETL_CHUNK_ROWS,
               text_dim: int = ETL_TEXT_DIM, n_categories: int = ETL_CATEGORIES, n_clusters: int = ETL_CLUSTERS,
               seed: int = SEED) -> dict:
    """Raw tables from seed -> both ETLs -> schema and stores, with the
    metadata schema's checks: the manifests' schema keeps the metadata's
    columns (each numeric one with its null flag), every id lies within its
    vocab and the text block is ``text_dim`` wide."""
    t0 = time.perf_counter()
    notice_raw, company_raw, pairs = etl_raw_tables(metadata, n_notices, n_companies, n_pairs, seed, n_categories,
                                                    n_clusters)
    raw_s = time.perf_counter() - t0
    meta_schema = schema_from_metadata_csv(metadata, text_embed_dim=text_dim)
    embedder = HashTextEmbedder(text_dim)
    out = {"pairs": pairs, "raw_s": raw_s, "raw": (notice_raw, company_raw)}
    for name, table in (("notice", notice_raw), ("company", company_raw)):
        side, store, manifest, columns, seconds = etl_side(name, table, metadata, chunk_rows, embedder)
        want = meta_schema.side(name)
        check(side.numeric_names == tuple(x for c in want.numeric_names for x in (f"{c}_is_null", c)),
              f"etl {name}: numeric outputs {side.numeric_names}")
        check(side.categorical_names == want.categorical_names and side.text_names == want.text_names,
              f"etl {name}: columns {side.categorical_names} {side.text_names}")
        check(store.cat_ids.shape == (len(table[side.pk[0]]), want.num_categorical)
              and store.dense.shape[1] == 2 * want.num_numeric + want.text_dim,
              f"etl {name}: store {store.dense.shape} {store.cat_ids.shape}")
        vocab = np.asarray(side.vocab_sizes)
        check(bool(((store.cat_ids >= 0) & (store.cat_ids < vocab[None, :])).all()), f"etl {name}: an id outside its vocab")
        check(bool(np.isfinite(store.dense).all()), f"etl {name}: non-finite features")
        out[name] = {"schema": side, "store": store, "manifest": manifest, "columns": columns, "seconds": seconds}
    out["schema"] = TwoTowerSchema(notice=out["notice"]["schema"], company=out["company"]["schema"])
    return out


def quickstart_launches() -> dict[str, int]:
    """The full quickstart's launches: its float32 towers demote the lookup
    to the gather (``resolve_lookup_mode``), whose backward is K2 on the
    card, twice per step; D = 32 lies outside the CE kernels' envelope, so
    the loss, the validation and the corpus eval are materialized; its one
    search (three notices over its companies, one step wide and one int8
    chunk) is the scan's top-k kernel's two launches and one int8 product."""
    size = quickstart.sizes(fast=False)
    steps = size["epochs"] * ((size["rows"] - size["val"]) // quickstart.BATCH_SIZE)
    return {name: 0 for name in read_counters()} | {"dense_table_grad": 2 * steps, "chunk_topk": 2, "int8_scan": 1}


def etl_serve_check(svc: RetrievalService, queries: list, hits: list, corpus: torch.Tensor) -> dict:
    """The int8 service's answers [Q, k] (per query batch of ``queries``)
    against a plain int8 scan of the same embeddings (bf16-rounded queries
    against the index's int8 rows times their scales, float32 sums), equal
    except at ties; and the int8 recall@k against an exact float32 scan of
    ``corpus``. The queries are encoded again in the service's batches."""
    values, scales = index_rows(svc.index, svc.index.values), index_rows(svc.index, svc.index.scales)[:, 0]
    tied, overlap, n = 0, 0, 0
    for batch, got in zip(queries, hits):
        q = svc.encode_queries(batch)

        def int8_scores(r, cols, q=q):
            return (q[r : r + 1].to(torch.bfloat16).float() @ values[cols].float().T)[0] * scales[cols]

        s8, i8 = torch.topk((q.to(torch.bfloat16).float() @ values.float().T) * scales, TOP_K, dim=1)
        tied += rows_tied_at_k(got, i8.cpu().numpy(), s8[:, -1].cpu().numpy(), q, corpus,
                               "etl int8 service vs plain int8 scan", score=int8_scores)
        exact = torch.topk(q @ corpus.T, TOP_K, dim=1).indices.cpu().numpy()
        overlap += sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got, exact))
        n += got.size
    return {"int8_rows_tied_vs_plain": tied, "int8_recall_at_100_vs_exact": overlap / n}


def etl_tfrecord_check(tmp: Path, columns: dict, name: str, key: str, planted_row: int) -> dict:
    """``columns`` (a table's preprocessed columns) exported to gzip
    TFRecord: the count equals the rows, reading back gives the same arrays,
    and ``search`` for the key of ``planted_row`` finds that row's record
    (and stops there). Rates are the file's bytes over the write and read
    seconds."""
    path = tmp / f"{name}.tfrecord.gz"
    n = len(columns[key])
    t0 = time.perf_counter()
    written = table_to_tfrecord(path, columns, compress=True)
    write_s = time.perf_counter() - t0
    mb = path.stat().st_size / 1e6
    check(written == n and count_records(path) == n, f"etl tfrecord {name}: {written} written, rows {n}")
    t0 = time.perf_counter()
    back = list(TFRecordReader(path).examples())
    read_s = time.perf_counter() - t0
    for col, arr in columns.items():
        arr = np.asarray(arr)
        if arr.dtype.kind in "US":
            got = np.asarray([ex[col][0].decode() for ex in back])
        else:
            got = np.asarray([ex[col] for ex in back], dtype=arr.dtype).reshape(arr.shape)
        check(np.array_equal(got, arr), f"etl tfrecord {name}: column {col} read back differs")
    want = str(columns[key][planted_row])
    t0 = time.perf_counter()
    hits = search_records(path, key, want.encode(), max_results=1)
    search_s = time.perf_counter() - t0
    check(len(hits) == 1 and hits[0] == back[planted_row], f"etl tfrecord {name}: search for {want} found {hits}")
    return {"rows": n, "columns": len(columns), "file_mb": mb, "write_s": write_s, "read_s": read_s,
            "search_s": search_s, "write_mb_per_s": mb / write_s, "read_mb_per_s": mb / read_s}


def etl_codec_check(tmp: Path, columns: dict, rows: int) -> dict:
    """The first ``rows`` rows of ``columns`` written to gzip TFRecord two
    ways: by ``table_to_tfrecord``, which passes each number as one Python
    float or int (the encoder's direct path), and row by row with their
    numpy scalars (its general path, the route of the JAX package's
    export). The two files must hold the same bytes once decompressed;
    the rates are the direct file's bytes over each way's seconds."""
    part = {c: np.asarray(v)[:rows] for c, v in columns.items()}
    direct, general = tmp / "codec_direct.tfrecord.gz", tmp / "codec_general.tfrecord.gz"
    t0 = time.perf_counter()
    table_to_tfrecord(direct, part, compress=True)
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with TFRecordWriter(general, compress=True) as w:
        for i in range(rows):
            w.write_example({c: a[i] for c, a in part.items()})
    general_s = time.perf_counter() - t0
    check(gzip.decompress(direct.read_bytes()) == gzip.decompress(general.read_bytes()),
          "etl tfrecord: the direct path's records differ from the general path's")
    mb = direct.stat().st_size / 1e6
    return {"rows": rows, "file_mb": mb, "direct_s": direct_s, "general_s": general_s,
            "direct_mb_per_s": mb / direct_s, "general_mb_per_s": mb / general_s}


def etl_phase() -> tuple[dict, dict]:
    """Raw tables -> ETL -> a trained, serving model, on the card, at the
    bench's width (module constants ETL_*):

    1. a reference-format metadata.csv, classified, and the schema built
       from it with the port's functions;
    2. the raw tables from seed; the ETL (``etl_stores``): the notice store
       holds the 29 numeric columns and their null flags, [N, 32] ids and
       [N, 768] text, every id within its vocab, and the unified notice
       table is [32768, 32];
    3. ``Trainer.train`` (``TrainConfig()`` at B=8192, seed 0, the
       flax-distributed init) for ETL_EPOCHS epochs with validation and the
       corpus eval after each: launches exact (``trainer_launches``), train
       loss falling, corpus recall@100 >= ETL_RECALL_FLOOR;
    4. ``RetrievalService(index_kind="int8")`` over the ETL-built companies
       answering ETL_SERVE_QUERIES held-out notices at k=100: K1 once per
       corpus encode chunk and query batch, the answers equal to a plain
       int8 scan except at ties, queries/s and the int8 recall@100;
    5. TFRecord: the company table and ETL_TFRECORD_NOTICES notices (their
       768-float titles) to gzip and back (``etl_tfrecord_check``), with the
       native CRC in use and equal to the Python one on 1 MiB, and
       ETL_CODEC_ROWS company rows through both encoder paths
       (``etl_codec_check``);
    6. ``quickstart.main`` at its full size on the card, launches exact
       (``quickstart_launches``: K6 and K11 never at D = 32).
    Returns the record and the launch counts of its three paths."""
    t_phase = time.perf_counter()
    cfg = TrainConfig().replace(
        data=dataclasses.replace(TrainConfig().data, batch_size=CE_BATCH),
        optimizer=dataclasses.replace(TrainConfig().optimizer, num_epochs=ETL_EPOCHS),
        results_csv="", seed=SEED)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_etl_"))
    try:
        metadata = etl_metadata_csv(tmp / "metadata.csv")
        data = etl_stores(metadata, ETL_NOTICES, ETL_COMPANIES, ETL_PAIRS)
        schema = data["schema"]
        n_store, c_store = data["notice"]["store"], data["company"]["store"]
        _, n_table = table_layout(schema.notice.vocab_sizes)
        check((n_table, cfg.model.categorical_embedding_dim) == (32768, 32),
              f"etl: the unified notice table is [{n_table}, {cfg.model.categorical_embedding_dim}], not [32768, 32]")
        check(n_store.dense.shape == (ETL_NOTICES, 2 * 29 + ETL_TEXT_DIM) and n_store.cat_ids.shape == (ETL_NOTICES, 32),
              f"etl: notice store {n_store.dense.shape} {n_store.cat_ids.shape}")
        print(f"etl: raw tables {data['raw_s']:.1f} s, notice ETL {data['notice']['seconds']:.1f} s, "
              f"company ETL {data['company']['seconds']:.1f} s, vocabs {schema.notice.vocab_sizes[:2]}... "
              f"tables [{n_table}, 32] and [{table_layout(schema.company.vocab_sizes)[1]}, 32]", flush=True)

        # -- training: the main path, counters from 0, read right after --------
        train_pairs, val_pairs = split_pairs(data["pairs"], cfg)
        logs: list[str] = []
        trainer = Trainer(cfg, schema, n_store, c_store, device="cuda", log_fn=logs.append)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.train(train_pairs, val_pairs, epoch_corpus_eval=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = read_counters()
        print("etl_train main path launches", json.dumps(train_launches), flush=True)
        print("\n".join(logs), flush=True)
        check_launches(train_launches, trainer_launches(ETL_EPOCHS, len(train_pairs), len(val_pairs), ETL_COMPANIES),
                       "etl_train")
        train_losses = [h["train_loss"] for h in res.history]
        check(bool(np.isfinite(train_losses).all()) and train_losses[-1] < train_losses[0],
              f"etl: train loss did not fall: {train_losses}")
        recall = res.corpus.recall[TOP_K]
        check(recall >= ETL_RECALL_FLOOR, f"etl: corpus recall@{TOP_K} {recall} < {ETL_RECALL_FLOOR}")
        steps = ETL_EPOCHS * (len(train_pairs) // CE_BATCH)

        # -- serving: the main path, counters from 0, read right after ---------
        state = FrozenState(res.state.state_dict)
        query_rows = val_pairs[:ETL_SERVE_QUERIES, 0]
        queries = [n_store.gather(query_rows[lo : lo + QUERY_BATCH]) for lo in range(0, len(query_rows), QUERY_BATCH)]
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = RetrievalService(trainer.model, cfg, state, c_store, index_kind="int8", device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = [svc.search(b, TOP_K).indices for b in queries]
        serve_s = time.perf_counter() - t0
        serve_launches = read_counters()
        print("etl_serve main path launches", json.dumps(serve_launches), flush=True)
        want = {c: 0 for c in serve_launches} | {"dense_table_lookup": math.ceil(ETL_COMPANIES / 8192) + len(queries),
                                                 "chunk_topk": 2 * math.ceil(ETL_COMPANIES / ct.WINDOW) * len(queries),
                                                 "int8_scan": len(queries)}  # the flat int8 index: one product a batch
        check(serve_launches == want, f"etl_serve: launches {serve_launches}, expected {want}")
        corpus = svc._evaluator.encode_corpus(svc.state, c_store.dense, c_store.cat_ids, side="company")
        answers = etl_serve_check(svc, queries, hits, corpus)
        history = res.history
        del svc, corpus, trainer, res

        # -- TFRecord -----------------------------------------------------------
        crc_bytes = np.random.default_rng(SEED).integers(0, 256, ETL_CRC_BYTES, dtype=np.uint8).tobytes()
        check(crc32c_io.backend() == "native", "etl: the TFRecord CRC is not the native library")
        check(crc32c_io.crc32c(crc_bytes) == crc32c_io._crc32c_py(crc_bytes), "etl: native CRC32C differs from Python's")
        notice_cols = {k: v[:ETL_TFRECORD_NOTICES] for k, v in data["notice"]["columns"].items()}
        tfrecord = {
            "company": etl_tfrecord_check(tmp, data["company"]["columns"], "company", "bizno", ETL_COMPANIES // 2 + 1),
            "notice": etl_tfrecord_check(tmp, notice_cols, "notice", "bidntceno", ETL_TFRECORD_NOTICES // 2 + 1),
        }
        codec = etl_codec_check(tmp, data["company"]["columns"], ETL_CODEC_ROWS)

        # -- the quickstart: the main path, counters from 0, read right after --
        os.environ.pop("QUICKSTART_FAST", None)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = run_cli(quickstart.main, ["--workdir", tmp / "quickstart"])
        torch.cuda.synchronize()
        quickstart_s = time.perf_counter() - t0
        qs_launches = read_counters()
        print("etl_quickstart main path launches", json.dumps(qs_launches), flush=True)
        check(qs_launches == quickstart_launches(),
              f"etl_quickstart: launches {qs_launches}, expected {quickstart_launches()}")
        lines = out.splitlines()
        check("ETL notice:" in out and "ETL company:" in out and "corpus retrieval over" in out
              and lines[-1].startswith("done"), "etl_quickstart: a printed marker is missing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    examples_per_sec = [h["examples_per_sec"] for h in history]
    row = {
        "notices": ETL_NOTICES, "companies": ETL_COMPANIES, "pairs": ETL_PAIRS, "chunk_rows": ETL_CHUNK_ROWS,
        "raw_tables_s": data["raw_s"],
        "etl_s": {side: data[side]["seconds"] for side in ("notice", "company")},
        "etl_rows_per_s": {side: len(data[side]["store"]) / data[side]["seconds"] for side in ("notice", "company")},
        "notice_table": [n_table, cfg.model.categorical_embedding_dim],
        "vocab_sizes": {side: sorted(set(schema.side(side).vocab_sizes)) for side in ("notice", "company")},
        "batch": CE_BATCH, "epochs": ETL_EPOCHS, "steps": steps, "train_s": train_s,
        "train_loss": train_losses, "val_loss": [h["val_loss"] for h in history],
        "examples_per_sec": examples_per_sec,
        "ms_per_step": [1e3 * CE_BATCH / x if x > 0 else None for x in examples_per_sec],
        "corpus_recall@10": history[-1]["corpus_recall@10"], "corpus_recall@100": recall,
        "serve_queries": len(query_rows), "serve_build_s": build_s, "serve_s": serve_s,
        "serve_qps": len(query_rows) / serve_s, **answers,
        "tfrecord": tfrecord, "tfrecord_codec": codec, "crc32c": crc32c_io.backend(), "quickstart_s": quickstart_s,
        "phase_s": time.perf_counter() - t_phase,
        "launches": {"train": train_launches, "serve": serve_launches, "quickstart": qs_launches},
    }
    print("etl " + json.dumps(row), flush=True)
    return row, {"etl_train": train_launches, "etl_serve": serve_launches, "etl_quickstart": qs_launches}


# -- the large-table paths (BASELINE config 3) -----------------------------------


def scaled_schema() -> TwoTowerSchema:
    """BASELINE config 3's towers (bench_suite.py:80-89): 16 numeric and 8
    categorical features of 1.25M ids each, per side."""

    def side(table: str) -> SideSchema:
        return SideSchema(
            table=table, pk=("id",),
            numeric=tuple(NumericSpec(f"n{i}") for i in range(SCALED_NUMERIC)),
            categorical=tuple(CategoricalSpec(f"c{i}", SCALED_VOCAB) for i in range(SCALED_FEATURES)),
        )

    return TwoTowerSchema(notice=side("notice"), company=side("company"))


def scaled_config(path: str, *, check: bool = False) -> TrainConfig:
    """BASELINE config 3's TrainConfig (bench_suite.py:90-96) for one path:
    "scaled_dense" asks for the reference's Pallas gather
    (``use_pallas_lookup``), the sparse paths for sparse tables, per step
    or once per window. ``check``: dropout 0 and SCALED_CHECK_ADAGRAD, for
    the sparse-against-dense check."""
    model = ModelConfig(categorical_embedding_dim=SCALED_DIM, dense_projection_dim=128,
                        tower_hidden_dims=(512, 256), final_embedding_dim=128)
    optimizer = OptimizerConfig(sparse_duplicate_handling="exact")
    if check:
        model = dataclasses.replace(model, dropout_rate=0.0)
        optimizer = dataclasses.replace(optimizer, **SCALED_CHECK_ADAGRAD)
    return TrainConfig(
        model=model, loss=LossConfig(use_fused_logits=True), optimizer=optimizer,
        mesh=MeshConfig(use_pallas_lookup=path == "scaled_dense"),
        sparse_tables=path != "scaled_dense", sparse_defer_updates=path == "scaled_sparse_deferred",
    )


SCALED_PATHS = ("scaled_dense", "scaled_sparse", "scaled_sparse_deferred")
SCALED_KERNELS = {  # launches per step on each path
    "scaled_dense": {"embedding_lookup_pallas": 2, "dense_table_lookup": 0, "dense_table_grad": 0,
                     "fused_lean_lse": 1, "fused_ce_bwd": 1},
    "scaled_sparse": {"embedding_lookup_pallas": 0, "dense_table_lookup": 0, "dense_table_grad": 0,
                      "fused_lean_lse": 1, "fused_ce_bwd": 1},
}
SCALED_KERNELS["scaled_sparse_deferred"] = SCALED_KERNELS["scaled_sparse"]


def scaled_steps(path: str, model, cfg, state_and_tx, n_steps: int):
    """The sampled steps of one path: n_steps per call, each batch drawn on
    the card."""
    state, tx = state_and_tx
    if path == "scaled_dense":
        return make_sampled_train_steps(model, cfg, tx, n_steps, SCALED_BATCH)
    if path == "scaled_sparse":
        return sparse_tables.make_sampled_sparse_steps(model, cfg, tx, bench.TOTAL_STEPS, n_steps, SCALED_BATCH)
    return sparse_tables.make_sampled_deferred_sparse_steps(model, cfg, tx, bench.TOTAL_STEPS, n_steps,
                                                            SCALED_BATCH)


def scaled_state(path: str, model, cfg):
    if path == "scaled_dense":
        return create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device="cuda")
    return sparse_tables.create_sparse_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device="cuda")


def scaled_dataset():
    """Config 3's data on the host: the synthetic generator's numeric
    features and pairs, categorical ids redrawn uniformly over each 1.25M
    vocab from numpy seed 0 (bench_suite.py:99-105)."""
    schema = scaled_schema()
    ds = make_synthetic_dataset(schema, n_notices=SCALED_NOTICES, n_companies=SCALED_NOTICES,
                                n_pairs=SCALED_PAIRS, n_clusters=SCALED_CLUSTERS, seed=SEED)
    rng = np.random.default_rng(SEED)
    for store in (ds.notice_store, ds.company_store):
        store.cat_ids[:] = rng.integers(0, SCALED_VOCAB, store.cat_ids.shape)
    return schema, ds


def scaled_data():
    """Config 3's stores and pairs on the card (:func:`scaled_dataset`)."""
    schema, ds = scaled_dataset()
    dtype = resolve_store_dtype(scaled_config("scaled_dense"))
    stores = [device_store(st, dtype=dtype, device="cuda") for st in (ds.notice_store, ds.company_store)]
    return schema, stores, torch.from_numpy(ds.pairs.astype(np.int64)).to("cuda")


def scaled_setup():
    """Config 3's data on the card and one model (random weights from seed
    0) that every scaled path starts from: (model, pairs, notice_store,
    company_store)."""
    t0 = time.perf_counter()
    schema, (notice_store, company_store), pairs = scaled_data()
    torch.manual_seed(SEED)  # the tables' and layers' initial draws
    model = build_model(schema, scaled_config("scaled_dense"))
    print(f"scaled: {sum(p.numel() for p in model.parameters())} params, tables "
          f"{model.notice_tower.embeddings.total_rows} x {SCALED_DIM} per tower, B={SCALED_BATCH} "
          f"(data, upload and model {time.perf_counter() - t0:.1f} s)", flush=True)
    return model, pairs, notice_store, company_store


def scaled_phase(setup) -> tuple[dict, dict]:
    """The three large-table paths at config 3, each from a fresh state of
    ``setup``'s model: one warm-up call and SCALED_TIMED_CALLS timed calls
    of SCALED_CALL_STEPS sampled steps, the launch counters read around all
    four, every loss finite; then a profiler breakdown of one more call for
    the device's busy share. Then the sparse-against-dense check. Returns
    the record and each path's launch counts."""
    model, pairs, notice_store, company_store = setup
    out, launches = {}, {}
    for path in SCALED_PATHS:
        cfg = scaled_config(path)
        work = scaled_state(path, model, cfg)
        steps = scaled_steps(path, model, cfg, work, SCALED_CALL_STEPS)
        state = work[0]

        def call(seed: int) -> np.ndarray:
            nonlocal state
            state, m = steps(state, seed, pairs, notice_store, company_store)
            return m["loss"].cpu().numpy()

        # -- the main path: counters from 0, read right after ------------------
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [call(0)]
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SCALED_TIMED_CALLS):
            losses.append(call(1 + i))
        timed_s = time.perf_counter() - t0
        launches[path] = read_counters()
        n_steps = SCALED_CALL_STEPS * (1 + SCALED_TIMED_CALLS)
        print(f"{path} main path launches", json.dumps(launches[path]), flush=True)
        for name, per_step in SCALED_KERNELS[path].items():
            check(launches[path][name] == per_step * n_steps,
                  f"{path}: kernel {name} launched {launches[path][name]} times in {n_steps} steps, "
                  f"expected {per_step} per step")
        losses = np.asarray(losses)
        check(bool(np.isfinite(losses).all()), f"{path}: non-finite loss {losses}")
        ms_per_step = timed_s * 1e3 / (SCALED_CALL_STEPS * SCALED_TIMED_CALLS)
        breakdown = device_breakdown(lambda: call(10_000 + state.step), repeats=1, top=10)
        out[path] = {"batch": SCALED_BATCH, "steps_per_call": SCALED_CALL_STEPS, "timed_calls": SCALED_TIMED_CALLS,
                     "warmup_call_s": warm_s, "ms_per_step": ms_per_step,
                     "examples_per_sec": SCALED_BATCH * 1e3 / ms_per_step,
                     "device_busy_share": breakdown["busy_share"],
                     "device_busy_share_timed": breakdown["device_ms_per_call"] / (ms_per_step * SCALED_CALL_STEPS),
                     "device_ms_per_call": breakdown["device_ms_per_call"],
                     "wall_ms_per_call": breakdown["wall_ms_per_call"], "top_ms": breakdown["top_ms"],
                     "device_events_per_call": breakdown["device_events_per_call"],
                     "loss_first_call": float(losses[0].mean()), "loss_last_call": float(losses[-1].mean()),
                     "launches": launches[path], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"{path} " + json.dumps(out[path]), flush=True)
        del work, steps, state
        torch.cuda.empty_cache()
    out["sparse_vs_dense"] = sparse_vs_dense_check(setup)
    return out, launches


def sparse_vs_dense_check(setup) -> dict:
    """From one state, dropout 0: SCALED_CHECK_STEPS per-step sparse steps
    with the exact dedup against as many scaled_dense steps (K4 forward,
    the full-table scatter and rowwise Adagrad), on the same batches drawn
    on the card (tests/test_sparse_tables.py:142-250 at config 3, with the
    accumulators of SCALED_CHECK_ADAGRAD). Each entry's change of the tables
    and accumulators must agree within SCALED_CHANGE_RTOL of the largest
    change plus SCALED_VALUE_ULPS of the entry; the dense params as
    SCALED_DENSE_SLACK_SHARE states. Holding the changes, not the values,
    keeps the check sharp: a step moves a table entry by about lr."""
    weights, pairs, notice_store, company_store = setup[0].state_dict(), *setup[1:]
    with torch.device("meta"):  # the towers under a dropout-free config, built without memory
        model = build_model(setup[0].schema, scaled_config("scaled_dense", check=True))
    model.load_state_dict(weights, assign=True)  # the same weights, not copied
    runs = {}
    for path in ("scaled_dense", "scaled_sparse"):
        cfg = scaled_config(path, check=True)
        work = scaled_state(path, model, cfg)
        steps = scaled_steps(path, model, cfg, work, SCALED_CHECK_STEPS)
        state, m = steps(work[0], SEED + 9, pairs, notice_store, company_store)
        runs[path] = (state, m["loss"].cpu().numpy())
        del work, steps
    (dense, dense_loss), (sparse, sparse_loss) = runs["scaled_dense"], runs["scaled_sparse"]
    opt = scaled_config("scaled_dense", check=True).optimizer
    row = {"steps": SCALED_CHECK_STEPS, "loss_dense": dense_loss.tolist(), "loss_sparse": sparse_loss.tolist(),
           "change_rtol": SCALED_CHANGE_RTOL, "value_ulps": SCALED_VALUE_ULPS, "check_adagrad": SCALED_CHECK_ADAGRAD}
    for key, field in sparse_tables.TABLE_KEYS.items():
        side = getattr(sparse, field)
        start_table = weights[key].to("cuda")
        for what, got, want, start in (
            ("table", side.table, dense.params[key], start_table),
            ("accumulator", side.accumulator, dense.opt_state["acc"][key],
             torch.full_like(side.accumulator, opt.adagrad_init_accumulator)),
        ):
            d_got, d_want = got - start, want - start
            scale = float(d_want.abs().max())
            excess = (d_got - d_want).abs() - SCALED_VALUE_ULPS * want.abs()
            err = float(excess.max())
            row[f"{field}.{what}"] = {"max_change": scale, "max_abs_err_past_ulps": err,
                                      "max_abs_err": float((d_got - d_want).abs().max()),
                                      "rows_changed": int((d_want.abs().sum(1) > 0).sum())}
            check(scale > 0 and err <= SCALED_CHANGE_RTOL * scale,
                  f"sparse vs dense {field} {what}: change differs by {err} past the ulps, largest change {scale}")
        del start_table
    worst, slack, entries = 0.0, 0, 0
    for k, v in sparse.dense_params.items():
        diff = (v - dense.params[k]).abs()
        worst = max(worst, float(diff.max()))
        slack += int((diff > 1e-6).sum())
        entries += diff.numel()
    row.update({"dense_params_max_abs_err": worst, "dense_params_share_past_1e-6": slack / entries,
                "lr": opt.learning_rate})
    print("scaled sparse vs dense " + json.dumps(row), flush=True)
    check(bool(np.allclose(dense_loss[0], sparse_loss[0], rtol=1e-6, atol=0)),
          f"first-step losses {dense_loss} vs {sparse_loss}")
    check(worst <= 2 * opt.learning_rate + 1e-6 and slack <= SCALED_DENSE_SLACK_SHARE * entries,
          f"sparse vs dense params: max {worst}, {slack} of {entries} entries past 1e-6")
    del runs, dense, sparse
    torch.cuda.empty_cache()
    return row


def step_grad_check() -> dict:
    """One training-form step at B=GRAD_CHECK_BATCH, dropout 0, from the same
    state and pairs: on the card (the kernels) and on the CPU (their plain
    versions: the config forces the one-hot lookup and the fused loss, so
    both run the same functions), plus a float32 reference on the CPU (f32
    towers, gather lookup, materialized f32 loss) that calibrates bf16's own
    noise. Gradients, not post-Adam params, since the first Adam step is
    about lr * sign(g) and a gradient near zero may take either sign. Each
    leaf's card gradient must lie within STEP_GRAD_NOISE_FACTOR times that
    leaf's own bf16 noise (the CPU bf16 gradient's distance from the f32
    one), plus STEP_GRAD_SLACK, of the CPU gradient (relative norms). The
    noise is measured from the gradient, so a leaf whose gradient is zero up
    to rounding (the bias of a layer that feeds a training-form BatchNorm,
    where the ReLU passes the whole batch) gets the wide tolerance its
    rounding earns and every other leaf a tight one; no leaf is exempt."""
    base = TrainConfig().model
    cfg = TrainConfig(
        model=dataclasses.replace(base, dropout_rate=0.0, embedding_lookup="onehot"),
        loss=LossConfig(use_fused_logits=True),
    )
    cfg32 = TrainConfig(
        model=dataclasses.replace(base, dropout_rate=0.0, compute_dtype="float32", embedding_lookup="gather"),
        loss=LossConfig(use_fused_logits=False),
    )
    schema = reference_shaped_schema()
    ds = make_synthetic_dataset(schema, n_notices=20_000, n_companies=20_000, n_pairs=GRAD_CHECK_BATCH,
                                n_clusters=bench.N_CLUSTERS, seed=SEED + 3)
    model = build_model(schema, cfg).init_weights(torch.Generator().manual_seed(SEED + 3))
    model32 = build_model(schema, cfg32)
    model32.load_state_dict(model.state_dict())
    results = {}
    for run, device, m, c in (("card", "cuda", model, cfg), ("cpu", "cpu", model, cfg), ("f32", "cpu", model32, cfg32)):
        state, _ = create_train_state(m, c, SEED, 1000, device=device)
        stores = [
            (torch.from_numpy(st.dense).to(torch.bfloat16).to(device), torch.from_numpy(st.cat_ids).to(device))
            for st in (ds.notice_store, ds.company_store)
        ]
        idx = torch.from_numpy(ds.pairs).to(device)
        batch = PairBatch(default_tower_gather(stores[0], idx[:, 0]), default_tower_gather(stores[1], idx[:, 1]))
        loss, _, grads = loss_and_grads(m, c, state, batch)
        results[run] = (float(loss), {k: g.float().cpu() for k, g in grads.items()})

    def rel(a: str, b: str) -> dict[str, float]:
        ref = results[b][1]
        return {k: float((g - ref[k]).norm() / ref[k].norm().clamp_min(1e-30)) for k, g in results[a][1].items()}

    card_vs_cpu, card_vs_f32, cpu_vs_f32 = rel("card", "cpu"), rel("card", "f32"), rel("cpu", "f32")
    tolerance = {k: STEP_GRAD_NOISE_FACTOR * v + STEP_GRAD_SLACK for k, v in cpu_vs_f32.items()}
    share = {k: card_vs_cpu[k] / tolerance[k] for k in tolerance}
    worst = max(share, key=share.get)
    loss_err = abs(results["card"][0] - results["cpu"][0])
    leaves = {k: {"card_vs_cpu": card_vs_cpu[k], "cpu_bf16_vs_f32": cpu_vs_f32[k], "card_vs_f32": card_vs_f32[k],
                  "tolerance": tolerance[k]} for k in sorted(share, key=share.get, reverse=True)}
    print("step gradient leaves " + json.dumps(leaves), flush=True)
    row = {"batch": GRAD_CHECK_BATCH, "loss_card": results["card"][0], "loss_cpu": results["cpu"][0],
           "loss_f32": results["f32"][0], "loss_abs_err": loss_err, "loss_tolerance": STEP_LOSS_ATOL,
           "max_grad_rel_err": max(card_vs_cpu.values()), "max_grad_rel_err_leaf": max(card_vs_cpu, key=card_vs_cpu.get),
           "worst_leaf_vs_tolerance": worst, "worst_card_vs_cpu": card_vs_cpu[worst],
           "worst_tolerance": tolerance[worst], "worst_share_of_tolerance": share[worst]}
    print("step card vs cpu " + json.dumps(row), flush=True)
    check(loss_err <= STEP_LOSS_ATOL, f"step loss card vs CPU: {loss_err} > {STEP_LOSS_ATOL}")
    check(share[worst] <= 1.0,
          f"step gradient {worst}: card vs CPU {card_vs_cpu[worst]} > tolerance {tolerance[worst]}")
    return row


# -- the mesh: two gloo ranks on the card, one NCCL rank through the CLIs ---------


def ranks_equal(mesh, tensors) -> bool:
    """Whether every rank holds the same bits of ``tensors`` (one all-gather)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])[None]
    every = mesh.all_gather_rows(flat)
    return all(torch.equal(every[0], every[r]) for r in range(1, mesh.size))


def mesh_config(batch: int, **loss) -> TrainConfig:
    base = TrainConfig()
    return base.replace(data=dataclasses.replace(base.data, batch_size=batch, sample_on_device=True),
                        loss=dataclasses.replace(base.loss, **loss), results_csv="")


def mesh_trainer(mesh, schema, ds) -> dict:
    """``Trainer(mesh=...).train`` at B=8192 on the bench's data, sampled on
    the card, MESH_EPOCHS epoch(s) in dispatches of MESH_N_INNER steps,
    validation after the epoch and at the end, the sharded corpus eval.
    Launches per rank exact (``trainer_launches``: each rank runs every
    step's kernels on its 4096 rows, every validation batch's on its
    block, and one encode per chunk of the corpus, on its half of it); the
    ranks' final states bit-equal; the sharded corpus eval equal to the
    single-device eval of the same embeddings, exactly."""
    cfg = mesh_config(CE_BATCH)
    cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, num_epochs=MESH_EPOCHS))
    train_pairs, val_pairs = split_pairs(ds.pairs, cfg)
    logs: list[str] = []
    trainer = Trainer(cfg, schema, ds.notice_store, ds.company_store, mesh=mesh, log_fn=logs.append)
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train(train_pairs, val_pairs, n_inner=MESH_N_INNER)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    print(f"mesh rank {mesh.rank} trainer main path launches", json.dumps(launches), flush=True)
    check_launches(launches, trainer_launches(MESH_EPOCHS, len(train_pairs), len(val_pairs), len(ds.company_store)),
                   f"mesh rank {mesh.rank} trainer")
    losses = [res.history[-1]["train_loss"], res.history[-1]["val_loss"], res.final_val["loss"]]
    check(bool(np.isfinite(losses).all()), f"mesh trainer: non-finite loss {losses}")
    check(ranks_equal(mesh, [*res.state.params.values(), *res.state.batch_stats.values()]),
          "mesh trainer: the ranks' final states differ")
    view = Trainer._eval_view(res.state)
    corpus_emb = trainer.evaluator.encode_corpus_device(view, trainer._dev_stores[1], len(ds.company_store))
    q_rows = val_pairs[:, 0]
    query_emb = trainer.evaluator.encode_corpus(view, ds.notice_store.dense[q_rows], ds.notice_store.cat_ids[q_rows],
                                                side="notice")
    sharded = sharded_corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1], mesh)
    single = corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1])
    check(sharded.recall == single.recall == res.corpus.recall and sharded.mrr == single.mrr == res.corpus.mrr,
          f"mesh corpus eval {sharded} != single-device {single} (trainer's {res.corpus})")
    return {"batch": CE_BATCH, "ranks": mesh.size, "epochs": MESH_EPOCHS, "n_inner": MESH_N_INNER,
            "steps": res.state.step, "train_loss": losses[0], "val_loss": losses[1],
            "val_recall@10": res.final_val["recall@10"], "corpus_recall@100": res.corpus.recall[100],
            "corpus_mrr": res.corpus.mrr, "examples_per_sec": res.history[-1]["examples_per_sec"],
            "wall_s": wall_s, "launches": launches}


def mesh_step_check(mesh, schema, ds) -> dict:
    """One step from one state at B=8192, dropout 0: the mesh step's loss
    and summed gradients against the port's single-device step on the whole
    batch, on the same card. The loss within MESH_LOSS_RTOL; each gradient
    leaf within the step check's gate (STEP_GRAD_NOISE_FACTOR times the
    leaf's own bf16 noise, the single-device bf16 gradient against a float32
    one on the card, plus STEP_GRAD_SLACK; relative norms)."""
    cfg = mesh_config(CE_BATCH)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32", embedding_lookup="gather"),
                        loss=dataclasses.replace(cfg.loss, use_fused_logits=False))
    stores = [device_store(st, dtype=resolve_store_dtype(cfg), device=mesh.device)
              for st in (ds.notice_store, ds.company_store)]
    idx = torch.from_numpy(ds.pairs[:CE_BATCH].astype(np.int64)).to(mesh.device)

    def batch(rows):
        return PairBatch(default_tower_gather(stores[0], rows[:, 0]), default_tower_gather(stores[1], rows[:, 1]))

    model = build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(SEED))
    state, _ = create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device=mesh.device)
    loss, _, grads = loss_and_grads(model, cfg, state, batch(idx[mesh.block(CE_BATCH)]), mesh=mesh,
                                    sharded_ce=make_sharded_ce(cfg, mesh))
    results = {}
    for run, c in (("single", cfg), ("f32", cfg32)):
        m = build_model(schema, c)
        m.load_state_dict(model.state_dict())
        st, _ = create_train_state(m, c, SEED, bench.TOTAL_STEPS, device=mesh.device)
        results[run] = loss_and_grads(m, c, st, batch(idx))

    def rel(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b}

    mesh_vs_single, noise = rel(grads, results["single"][2]), rel(results["single"][2], results["f32"][2])
    tolerance = {k: STEP_GRAD_NOISE_FACTOR * v + STEP_GRAD_SLACK for k, v in noise.items()}
    share = {k: mesh_vs_single[k] / tolerance[k] for k in tolerance}
    worst = max(share, key=share.get)
    loss_rel = abs(float(loss) - float(results["single"][0])) / abs(float(results["single"][0]))
    check(loss_rel <= MESH_LOSS_RTOL, f"mesh step loss {float(loss)} vs single {float(results['single'][0])}")
    check(share[worst] <= 1.0, f"mesh step gradient {worst}: {mesh_vs_single[worst]} > {tolerance[worst]}")
    return {"batch": CE_BATCH, "loss_mesh": float(loss), "loss_single": float(results["single"][0]),
            "loss_rel_err": loss_rel, "loss_tolerance_rel": MESH_LOSS_RTOL,
            "max_grad_rel_err": max(mesh_vs_single.values()), "worst_leaf": worst,
            "worst_share_of_tolerance": share[worst]}


def mesh_steps(mesh, schema, ds, batch_size: int, eps: float) -> dict:
    """MESH_EXTRA_STEPS mesh steps at global B = ``batch_size`` with label
    smoothing ``eps`` from a fresh state, each on a seeded global batch:
    launches per rank exact (B=16384: K7 and K10 at 8192 rows against
    16384; eps=0.1: K8, K5 and K11 at row offset 4096 on rank 1), every loss
    finite, and the ranks' states bit-equal after every step."""
    cfg = mesh_config(batch_size, label_smoothing=eps)
    model = build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(SEED))
    state, _, _, step, put_idx, _ = make_sharded_indexed_train(model, cfg, mesh, batch_size, bench.TOTAL_STEPS,
                                                               n_inner=1)
    stores = [device_store(st, dtype=resolve_store_dtype(cfg), device=mesh.device)
              for st in (ds.notice_store, ds.company_store)]
    rng = np.random.default_rng(SEED + 11)
    idx = [ds.pairs[rng.integers(0, len(ds.pairs), size=batch_size)] for _ in range(MESH_EXTRA_STEPS)]
    equal, losses = [], []
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in idx:
        state, m = step(state, put_idx(i), *stores)
        losses.append(float(m["loss"]))
        equal.append(ranks_equal(mesh, [*state.params.values(), *state.batch_stats.values()]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    n = MESH_EXTRA_STEPS
    expected = step_launches(n) if eps == 0 else {**step_launches(n), "fused_lean_lse": 0, "same_tile_diag": n,
                                                   "fused_stats_sweep": n}
    check_launches(launches, expected, f"mesh rank {mesh.rank} B={batch_size} eps={eps}")
    check(all(equal), f"mesh B={batch_size} eps={eps}: the ranks' states differ after a step ({equal})")
    check(bool(np.isfinite(losses).all()), f"mesh B={batch_size} eps={eps}: non-finite loss {losses}")
    return {"batch": batch_size, "rows_per_rank": batch_size // mesh.size, "label_smoothing": eps,
            "steps": n, "losses": losses, "ranks_equal_every_step": all(equal), "wall_s": wall_s,
            "launches": launches}


def mesh_index(mesh) -> dict:
    """``ShardedIndex`` over N_COMPANIES unit rows (rank 0's, broadcast), each
    rank holding half, exact and int8: QUERY_BATCH queries at k = TOP_K
    against the single-device index of the whole corpus on the same card,
    the sets equal except at ties (``rows_tied_at_k``), scores within 1e-5."""
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 5)
    corpus = put_replicated(unit_rows(gen, N_COMPANIES, CE_DIM, mesh.device), mesh)
    queries = put_replicated(unit_rows(gen, QUERY_BATCH, CE_DIM, mesh.device), mesh)
    out = {"companies": N_COMPANIES, "queries": QUERY_BATCH, "k": TOP_K}
    for kind, single_cls in (("exact", BruteForceIndex), ("int8", Int8Index)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ShardedIndex(corpus, mesh, kind=kind)
        got = index.search(queries, TOP_K)
        search_s = time.perf_counter() - t0
        want = single_cls(corpus, device=mesh.device).search(queries, TOP_K)
        check(bool(np.abs(got.scores - want.scores).max() <= 1e-5),
              f"ShardedIndex {kind}: scores differ by {np.abs(got.scores - want.scores).max()}")
        score = None
        if kind == "int8":
            ref = Int8Index(corpus, device=mesh.device)
            values, scales = index_rows(ref, ref.values), index_rows(ref, ref.scales)

            def score(r, rows, values=values, scales=scales):
                q = queries[r].to(torch.bfloat16).float()
                return (values[rows].float() @ q) * scales[rows, 0]
        ties = rows_tied_at_k(got.indices, want.indices, want.scores[:, -1], queries, corpus,
                              f"ShardedIndex {kind} vs single-device", score)
        out[kind] = {"build_and_search_s": search_s, "rows_tied_at_k": ties, "shard_rows": index.shard_rows}
    return out


def compressed_config(method: str, negatives: str, **model) -> TrainConfig:
    """The mesh phase's config (``TrainConfig()`` at B=8192, sampled on the
    card) with the compressed sync ``method`` and ``negatives``."""
    cfg = mesh_config(CE_BATCH)
    return cfg.replace(mesh=dataclasses.replace(cfg.mesh, grad_compression=method, compressed_negatives=negatives),
                       model=dataclasses.replace(cfg.model, **model),
                       optimizer=dataclasses.replace(cfg.optimizer, num_epochs=MESH_EPOCHS))


def half_bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half of bf16's unit in the last place at each |x| (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 9)


def compressed_first_losses(mesh, schema, stores, idx, cfg_seed: int) -> dict:
    """From one state (the Trainer's init from ``cfg_seed``), the first
    step's loss under every method and both negatives: bit-equal across
    methods (the loss comes before the sync, __graft_entry__.py mode 8)."""
    out = {}
    model = build_model(schema, compressed_config("int16", "local"), mesh)
    model.init_flax(torch.Generator().manual_seed(cfg_seed))
    for negatives in COMPRESSED_NEGATIVES:
        losses = {}
        for method in COMPRESSED_METHODS:
            cfg = compressed_config(method, negatives)
            built = compressed_grads.make_dp_compressed_indexed_train(model, cfg, mesh, CE_BATCH, bench.TOTAL_STEPS,
                                                                      method=method)
            _, _, m = built.single_step(built.state, built.err_state, built.put_idx(idx), *stores)
            losses[method] = float(m["loss"])
        check(len(set(losses.values())) == 1, f"mesh_compressed {negatives}: first losses differ {losses}")
        out[negatives] = losses
    return out


def compressed_wire_check(mesh, schema, stores, idx) -> dict:
    """On one step's gradients (the rank's own, local negatives): the int16
    total against a float64 sum of the gathered quanta times the scale, leaf
    by leaf with a collective each, bit for bit; each residual within half
    a quantum of zero; bf16's within half a bf16 ulp of g + err; and the
    bytes each format puts on the wire, from its buffers."""
    cfg = compressed_config("int16", "local")
    model = build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(SEED))
    state, _ = create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device=mesh.device)
    block = idx[mesh.block(CE_BATCH)] if idx.shape[0] == CE_BATCH else idx
    batch = PairBatch(default_tower_gather(stores[0], block[:, 0]), default_tower_gather(stores[1], block[:, 1]))
    _, _, grads = loss_and_grads(model, cfg, state, batch)
    zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
    out = {"params": int(sum(g.numel() for g in grads.values())), "leaves": len(grads), "wire_bytes_per_rank": {}}
    buffers = {}
    for method in COMPRESSED_METHODS:
        buffers[method] = []
        synced, err = compressed_grads.compressed_psum_tree(grads, zeros, mesh, method, buffers=buffers[method])
        if method == "int16":
            worst_err_share = 0.0
            for k, g in grads.items():
                m = mesh.all_reduce_(g.abs().max().reshape(1), "max")
                scale = m.clamp_min(1e-30) / 127.0
                q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
                every = mesh.all_gather_rows(q.reshape(1, -1))
                want = (every.double().sum(0) * scale.double()).float().view(g.shape)
                check(torch.equal(synced[k], want), f"mesh_compressed int16 total of {k} differs from the f64 sum")
                worst_err_share = max(worst_err_share, float(err[k].abs().max() / (scale / 2)))
            # half a quantum, up to the f32 rounding of g / scale (127 x 2^-24 of a quantum)
            check(worst_err_share <= 1.0 + 1e-5,
                  f"mesh_compressed int16 residual past half a quantum ({worst_err_share})")
            out["int16_residual_max_share_of_half_quantum"] = worst_err_share
        elif method == "bf16":
            worst = max(float((err[k].abs() - half_bf16_ulp(g.float())).max()) for k, g in grads.items())
            check(worst <= 0.0, f"mesh_compressed bf16 residual past half an ulp by {worst}")
            out["bf16_residual_within_half_ulp"] = True
        else:
            check(all(not e.any() for e in err.values()), "mesh_compressed none: residual not zero")
    for n in COMPRESSED_WIRE_RANKS:
        row = {m: compressed_grads.ring_wire_bytes(b, n) for m, b in buffers.items()}
        row["f32_ring_all_reduce"] = compressed_grads.ring_wire_bytes([("all_reduce", 4 * out["params"])], n)
        out["wire_bytes_per_rank"][n] = row
    out["buffers"] = buffers
    return out


def compressed_global_check(mesh, schema, ds, stores, pairs_dev) -> dict:
    """"global" negatives under "none", dropout 0 and no BatchNorm, against
    the uncompressed mesh step (``make_sampled_train_steps(..., mesh=)``) on
    the same draws from one state: the loss within MESH_LOSS_RTOL, the
    summed gradients of every leaf within STEP_GRAD_SLACK of the mesh
    step's (relative norms, the step check's slack), and the params after
    the step within 2 lr (Adam's first step moves an entry by about lr
    sign(g), so a gradient at rounding noise may step either way)."""
    model_kw = dict(dropout_rate=0.0, use_batch_norm=False)
    cfg = compressed_config("none", "global", **model_kw)
    mesh_cfg = compressed_config("none", "local", **model_kw)  # grad_compression "none": the uncompressed mesh
    model_u = build_model(schema, mesh_cfg, mesh).init_flax(torch.Generator().manual_seed(SEED))
    model_c = build_model(schema, cfg.replace(mesh=dataclasses.replace(cfg.mesh, grad_compression="int16")), mesh)
    model_c.load_state_dict(model_u.state_dict())
    sample_seed = SEED + 31
    rows = torch.randint(0, len(pairs_dev), (CE_BATCH,), generator=step_generator(mesh.device, sample_seed, 0,
                                                                                  SAMPLE_STREAM),
                         device=mesh.device)[mesh.block(CE_BATCH)]
    idx = pairs_dev.index_select(0, rows)
    batch = PairBatch(default_tower_gather(stores[0], idx[:, 0]), default_tower_gather(stores[1], idx[:, 1]))
    # the summed gradients of both, from one state
    state_u, tx_u = create_train_state(model_u, mesh_cfg, SEED, bench.TOTAL_STEPS, device=mesh.device)
    _, _, grads_u = loss_and_grads(model_u, mesh_cfg, state_u, batch, mesh=mesh,
                                   sharded_ce=make_sharded_ce(mesh_cfg, mesh))
    built = compressed_grads.make_dp_compressed_indexed_train(model_c, cfg, mesh, CE_BATCH, bench.TOTAL_STEPS,
                                                              method="none")
    built.sync.err = built.err_state
    _, _, grads_c = loss_and_grads(model_c, cfg, built.state, batch, sharded_ce=built.sync.sharded_ce,
                                   sync=built.sync)
    grad_rel = {k: float((grads_c[k] - g).norm() / g.norm().clamp_min(1e-30)) for k, g in grads_u.items()}
    # then one step of each
    built = compressed_grads.make_dp_compressed_indexed_train(model_c, cfg, mesh, CE_BATCH, bench.TOTAL_STEPS,
                                                              method="none")
    state_c, _, m_c = built.single_step(built.state, built.err_state, idx, *stores)
    state_u, tx_u = create_train_state(model_u, mesh_cfg, SEED, bench.TOTAL_STEPS, device=mesh.device)
    state_u, m_u = make_sampled_train_steps(model_u, mesh_cfg, tx_u, 1, CE_BATCH, mesh=mesh)(
        state_u, sample_seed, pairs_dev, *stores)
    loss_u, loss_c = float(m_u["loss"][0]), float(m_c["loss"])
    loss_rel = abs(loss_c - loss_u) / abs(loss_u)
    param_diff = max(float((state_c.params[k] - p).abs().max()) for k, p in state_u.params.items())
    worst = max(grad_rel, key=grad_rel.get)
    lr = mesh_cfg.optimizer.learning_rate
    check(loss_rel <= MESH_LOSS_RTOL, f"mesh_compressed global: loss {loss_c} vs the mesh step's {loss_u}")
    check(grad_rel[worst] <= STEP_GRAD_SLACK, f"mesh_compressed global: gradient of {worst} off by {grad_rel[worst]}")
    check(param_diff <= 2 * lr, f"mesh_compressed global: params off by {param_diff} after one step")
    return {"loss_compressed": loss_c, "loss_mesh": loss_u, "loss_rel_err": loss_rel,
            "loss_tolerance_rel": MESH_LOSS_RTOL, "max_grad_rel_err": grad_rel[worst], "worst_leaf": worst,
            "grad_tolerance_rel": STEP_GRAD_SLACK, "max_param_abs_diff": param_diff, "param_tolerance_abs": 2 * lr}


def equal_after_every_call(mesh, built, seen: list):
    """``built`` (a CompressedDPTrain) with each call followed by the check
    that every rank holds the same state bits (``seen`` collects one bool a
    call)."""

    def wrap(fn):
        def call(state, err, *args):
            state, err, m = fn(state, err, *args)
            seen.append(ranks_equal(mesh, [*state.params.values(), *state.batch_stats.values()]))
            return state, err, m

        return call

    make_sampled = built.make_sampled
    return dataclasses.replace(built, scan_steps=wrap(built.scan_steps), single_step=wrap(built.single_step),
                               make_sampled=lambda k: wrap(make_sampled(k)))


def compressed_trainer(mesh, schema, ds, method: str, first_loss: float) -> dict:
    """``Trainer(mesh=...).train`` under ``method`` with local negatives for
    MESH_EPOCHS sampled epoch(s) in dispatches of MESH_N_INNER, validation,
    no corpus eval: launches per rank exact, the ranks' states bit-equal
    after every call, the epoch's loss below ``first_loss`` (its first
    step's, ``compressed_control``), peak memory."""
    import jodalrob_twotower_torch.train.trainer as trainer_module

    cfg = compressed_config(method, "local")
    train_pairs, val_pairs = split_pairs(ds.pairs, cfg)
    seen: list[bool] = []
    make = trainer_module.make_dp_compressed_indexed_train
    trainer_module.make_dp_compressed_indexed_train = lambda *a, **k: equal_after_every_call(mesh, make(*a, **k), seen)
    try:
        trainer = Trainer(cfg, schema, ds.notice_store, ds.company_store, mesh=mesh, log_fn=lambda *_: None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        # -- the main path: counters from 0, read right after ----------------------
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.train(train_pairs, val_pairs, n_inner=MESH_N_INNER, corpus_eval=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
    finally:
        trainer_module.make_dp_compressed_indexed_train = make
    steps = MESH_EPOCHS * (len(train_pairs) // CE_BATCH)
    check_launches(launches, step_launches(steps, (MESH_EPOCHS + 1) * (len(val_pairs) // CE_BATCH)),
                   f"mesh_compressed rank {mesh.rank} {method} trainer")
    check(bool(seen) and all(seen), f"mesh_compressed {method}: the ranks' states differ after a call ({seen})")
    loss = res.history[-1]["train_loss"]
    check(bool(np.isfinite([loss, res.final_val["loss"]]).all()), f"mesh_compressed {method}: non-finite loss")
    check(loss < first_loss, f"mesh_compressed {method}: the epoch's loss {loss} did not fall below {first_loss}")
    return {"steps": res.state.step, "first_loss": first_loss, "train_loss": loss, "val_loss": res.final_val["loss"],
            "val_recall@10": res.final_val["recall@10"], "examples_per_sec": res.history[-1]["examples_per_sec"],
            "ms_per_step": CE_BATCH * 1e3 / res.history[-1]["examples_per_sec"], "wall_s": wall_s,
            "calls_checked_equal": len(seen), "peak_memory_gb": torch.cuda.max_memory_allocated(mesh.device) / 1e9,
            "launches": launches}


def compressed_control(mesh, schema, ds, stores) -> dict:
    """The "none" wire (f32, local negatives, per-rank statistics) over the
    sampled epoch that ``compressed_trainer`` runs, through
    ``make_dp_compressed_indexed_train`` as the Trainer calls it: the same
    init, schedule, draws and dispatches of MESH_N_INNER. The Trainer takes
    grad_compression "none" for the uncompressed mesh, so this is the int16
    and bf16 runs' control, as in tests/test_compressed_grads.py:97-139. Its
    first loss is theirs (the loss comes before the sync)."""
    cfg = compressed_config("none", "local")
    train_pairs, _ = split_pairs(ds.pairs, cfg)
    steps = MESH_EPOCHS * (len(train_pairs) // CE_BATCH)
    model = build_model(schema, compressed_config("int16", "local"), mesh)
    model.init_flax(torch.Generator().manual_seed(cfg.seed))
    built = compressed_grads.make_dp_compressed_indexed_train(model, cfg, mesh, CE_BATCH, max(steps, 1), method="none")
    pairs_dev = torch.from_numpy(np.asarray(train_pairs, np.int64)).to(mesh.device)
    state, err, losses = built.state, built.err_state, []
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for done in range(0, steps, MESH_N_INNER):
        state, err, m = built.make_sampled(min(MESH_N_INNER, steps - done))(state, err, cfg.data.shuffle_seed,
                                                                             pairs_dev, *stores)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    check_launches(launches, step_launches(steps), f"mesh_compressed rank {mesh.rank} none control")
    losses = torch.cat(losses).cpu().numpy()
    train_loss = float(losses[-min(len(losses), 20):].mean())  # the Trainer's train_loss
    check(bool(np.isfinite(losses).all()) and train_loss < losses[0],
          f"mesh_compressed none: the epoch's loss {train_loss} did not fall below {losses[0]}")
    return {"steps": steps, "first_loss": float(losses[0]), "train_loss": train_loss, "wall_s": wall_s,
            "launches": launches}


def compressed_timed(mesh, schema, stores, pairs_dev) -> dict:
    """ms/step a rank of each method and negatives: one warm-up call and one
    timed call of COMPRESSED_TIMED_STEPS sampled steps, from the Trainer's
    config; launches exact over the timed call."""
    out = {}
    model = build_model(schema, compressed_config("int16", "local"), mesh)
    model.init_flax(torch.Generator().manual_seed(SEED))
    for negatives in COMPRESSED_NEGATIVES:
        for method in COMPRESSED_METHODS:
            cfg = compressed_config(method, negatives)
            built = compressed_grads.make_dp_compressed_indexed_train(model, cfg, mesh, CE_BATCH, bench.TOTAL_STEPS,
                                                                      method=method)
            steps = built.make_sampled(COMPRESSED_TIMED_STEPS)
            state, err, _ = steps(built.state, built.err_state, SEED, pairs_dev, *stores)
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, err, m = steps(state, err, SEED, pairs_dev, *stores)
            losses = m["loss"].cpu().numpy()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / COMPRESSED_TIMED_STEPS
            launches = read_counters()
            check_launches(launches, step_launches(COMPRESSED_TIMED_STEPS),
                           f"mesh_compressed rank {mesh.rank} {method} {negatives} timed")
            check(bool(np.isfinite(losses).all()), f"mesh_compressed {method} {negatives}: non-finite losses")
            out[f"{method}_{negatives}"] = {"ms_per_step": ms, "loss_last": float(losses[-1]), "launches": launches}
    return out


def mesh_compressed(mesh, schema, ds) -> dict:
    """The compressed gradient sync on this rank, at the mesh phase's width
    and data (global B=8192, 4,096 rows a rank): first losses, the wire,
    "global" against the mesh step, the Trainer per method, and the timed
    calls. Any failed check raises, which fails the launch."""
    t0 = time.perf_counter()
    dtype = resolve_store_dtype(mesh_config(CE_BATCH))
    stores = [device_store(st, dtype=dtype, device=mesh.device) for st in (ds.notice_store, ds.company_store)]
    pairs_dev = torch.from_numpy(ds.pairs.astype(np.int64)).to(mesh.device)
    idx = ds.pairs[:CE_BATCH].astype(np.int64)
    cfg_seed = compressed_config("int16", "local").seed
    out = {"rank": mesh.rank, "batch": CE_BATCH, "rows_per_rank": CE_BATCH // mesh.size}
    out["first_losses"] = compressed_first_losses(mesh, schema, stores, idx, cfg_seed)
    out["wire"] = compressed_wire_check(mesh, schema, stores, torch.from_numpy(idx).to(mesh.device))
    out["global_check"] = compressed_global_check(mesh, schema, ds, stores, pairs_dev)
    out["trainer"] = {"none": compressed_control(mesh, schema, ds, stores)}
    for m in COMPRESSED_METHODS[1:]:
        out["trainer"][m] = compressed_trainer(mesh, schema, ds, m, out["trainer"]["none"]["first_loss"])
    finals = {m: r["train_loss"] for m, r in out["trainer"].items()}
    for m in ("int16", "bf16"):
        rel = abs(finals[m] - finals["none"]) / abs(finals["none"])
        check(rel <= COMPRESSED_LEARN_REL, f"mesh_compressed {m}: final loss {finals[m]} vs none's {finals['none']}")
    out["final_loss_rel_to_none"] = {m: abs(finals[m] - finals["none"]) / abs(finals["none"]) for m in ("int16", "bf16")}
    out["timed"] = compressed_timed(mesh, schema, stores, pairs_dev)
    del stores, pairs_dev
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


def mesh_rank(devices: list) -> dict:
    """One rank of the mesh phase's (a) half: the bench's data built from
    its seed, then the trainer, the step check, B=16384, label smoothing and
    the sharded index. Any failed check raises, which fails the launch."""
    mesh = make_mesh(devices)
    torch.cuda.set_device(mesh.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    schema = reference_shaped_schema()
    t0 = time.perf_counter()
    ds = make_synthetic_dataset(schema, n_notices=bench.N_NOTICES, n_companies=bench.N_COMPANIES,
                                n_pairs=bench.N_PAIRS, n_clusters=bench.N_CLUSTERS, seed=SEED)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
           "data_s": time.perf_counter() - t0}
    out["trainer"] = mesh_trainer(mesh, schema, ds)
    out["step_check"] = mesh_step_check(mesh, schema, ds)
    out["b16384"] = mesh_steps(mesh, schema, ds, BLOCKED_BATCHES[0], 0.0)
    out["ls0.1"] = mesh_steps(mesh, schema, ds, CE_BATCH, 0.1)
    out["compressed"] = mesh_compressed(mesh, schema, ds)
    print(f"mesh_compressed rank {mesh.rank} " + json.dumps(out["compressed"]), flush=True)
    out["index"] = mesh_index(mesh)
    return out


def mesh_cli_check(out_dir: Path) -> tuple[dict, dict]:
    """(b): the three CLIs in-process with ``--mesh-devices 1`` (one rank
    over NCCL: its gradient all-reduce, broadcasts, gathers and barriers
    launch on the card) beside the same runs without it, at the tiny
    synthetic scale, B=1024 sampled on the card for one epoch. A one-rank
    mesh runs the single-device CE, so the train losses, validation metrics
    and final weights must be bit-equal, the launches equal, the eval
    reports and the serve answers equal."""
    train_args = ["--synthetic", "--synthetic-scale", "tiny", "--epochs", "1", "--batch-size", "1024",
                  "--sample-on-device"]
    runs, launches = {}, {}
    for tag, extra in (("plain", []), ("mesh1", ["--mesh-devices", "1"])):
        d = out_dir / tag
        # -- the main path: counters from 0, read right after ----------------------
        reset_counters()
        stdout, _ = run_cli(train.main, train_args + extra + ["--output-dir", d, "--results-csv", d / "results.csv",
                                                              "--metrics-jsonl", d / "metrics.jsonl"])
        launches[f"{tag}_train"] = read_counters()
        runs[tag] = {"stdout": stdout, "metrics": [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()],
                     "weights": torch.load(d / "weights" / "state.pt", weights_only=True)}
        for cli, argv in (("eval", [eval_cli.main, ["--model-dir", out_dir / "plain", "--output", d / "eval.json"]]),
                          ("serve", [serve.main, ["--model-dir", out_dir / "plain", "--queries", "1024", "--k",
                                                  str(TOP_K), "--output", d / "serve.jsonl"]])):
            reset_counters()
            run_cli(argv[0], argv[1] + extra)
            launches[f"{tag}_{cli}"] = read_counters()
    # one NCCL rank with row-sharded stores: the exchange's gather and
    # reduce-scatter launch on the card and leave the rows as they are
    d = out_dir / "mesh1_rows"
    reset_counters()
    stdout, _ = run_cli(train.main, train_args + ["--mesh-devices", "1", "--store-sharding", "rows", "--output-dir", d,
                                                  "--results-csv", d / "results.csv", "--metrics-jsonl",
                                                  d / "metrics.jsonl"])
    launches["mesh1_rows_train"] = read_counters()
    runs["mesh1_rows"] = {"stdout": stdout,
                          "metrics": [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()],
                          "weights": torch.load(d / "weights" / "state.pt", weights_only=True)}
    check("stores rows" in stdout, "mesh1_rows: the training CLI did not place row-sharded stores")
    check(launches["mesh1_rows_train"] == launches["plain_train"],
          f"mesh1_rows train launches {launches['mesh1_rows_train']} != {launches['plain_train']}")
    # its checkpoint restores on one device (the CLI's config, the card)
    cfg1 = TrainConfig.from_json(d / "config.json")
    m1 = build_model(tiny_synthetic_schema(), cfg1)
    one, _ = create_train_state(m1, cfg1, cfg1.seed, 10, device="cuda")
    restored = CheckpointManager(d, cfg1.checkpoint).restore("final", one)
    for k, v in runs["mesh1_rows"]["weights"]["params"].items():
        check(torch.equal(restored.params[k], v), f"mesh1_rows final checkpoint differs from its weights at {k}")
    check("over nccl" in runs["mesh1"]["stdout"], "mesh1: the training CLI did not run over NCCL")
    clocks = ("examples_per_sec", "time")  # each run's own clock

    def strip(tag):
        return [{k: v for k, v in m.items() if k not in clocks} for m in runs[tag]["metrics"]]

    for tag in ("mesh1", "mesh1_rows"):
        check(strip("plain") == strip(tag), f"{tag} metrics differ: {runs[tag]['metrics']} vs {runs['plain']['metrics']}")
        for part in ("params", "batch_stats"):
            for k, v in runs["plain"]["weights"][part].items():
                check(torch.equal(v, runs[tag]["weights"][part][k]), f"{tag} weights differ at {k}")
    for cli in ("train", "eval", "serve"):
        check(launches[f"plain_{cli}"] == launches[f"mesh1_{cli}"],
              f"mesh1 {cli} launches {launches[f'mesh1_{cli}']} != {launches[f'plain_{cli}']}")
    a, b = (json.loads((out_dir / t / "eval.json").read_text()) for t in ("plain", "mesh1"))
    check({k: v for k, v in a.items() if k != "model_dir"} == {k: v for k, v in b.items() if k != "model_dir"},
          "mesh1 eval report differs")
    ties = 0
    for x, y in zip(*(map(json.loads, (out_dir / t / "serve.jsonl").read_text().splitlines())
                      for t in ("plain", "mesh1"))):
        # the same scores in the same places; the same companies but where
        # scores tie (the merge of the shards' candidates orders ties anew)
        hx, hy = ([(h["score"], h["company"]) for h in row["top_k"]] for row in (x, y))
        check(x["notice"] == y["notice"] and [s for s, _ in hx] == [s for s, _ in hy],
              f"mesh1 serve scores differ for notice {x['notice']}")
        tied = {s for s, _ in hx if [t for t, _ in hx].count(s) > 1}
        check(sorted(h for h in hx if h[0] not in tied) == sorted(h for h in hy if h[0] not in tied),
              f"mesh1 serve answers differ beyond ties for notice {x['notice']}")
        ties += hx != hy
    row = {"train_loss": runs["mesh1"]["metrics"][-1]["train_loss"], "val_loss": runs["mesh1"]["metrics"][-1]["val_loss"],
           "bit_equal": True, "rows_store_bit_equal": True, "rows_checkpoint_restores_on_one_device": True,
           "serve_rows_ordered_apart_at_ties": ties, "launches": launches}
    return row, {"mesh1_train": launches["mesh1_train"], "mesh1_rows_train": launches["mesh1_rows_train"]}


def mesh_phase() -> tuple[dict, dict]:
    """(a) MESH_RANKS ranks over gloo on the one card (``mesh_rank``; NCCL
    refuses two ranks on one device), through the port's launcher with a
    process-group timeout and a deadline; then (b) ``mesh_cli_check``.
    Times in (a) are gloo's, whose collectives stage CUDA tensors through
    the host. Returns the record and rank 0's launch counts per path."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, args=(["cuda:0"] * MESH_RANKS,), backend="gloo",
                   devices=["cuda:0"] * MESH_RANKS, timeout_s=MESH_PG_S, join_timeout_s=MESH_JOIN_S)
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        print(f"mesh rank {r['rank']} " + json.dumps(r), flush=True)
    check(ranks[0]["trainer"]["train_loss"] == ranks[1]["trainer"]["train_loss"], "mesh: the ranks' losses differ")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        t1 = time.perf_counter()
        cli, cli_launches = mesh_cli_check(tmp)
        cli_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    for m in COMPRESSED_METHODS:
        check(ranks[0]["compressed"]["trainer"][m]["train_loss"] == ranks[1]["compressed"]["trainer"][m]["train_loss"],
              f"mesh_compressed {m}: the ranks' losses differ")
    compressed = {k: v for k, v in r0["compressed"].items() if k != "rank"}
    compressed["per_rank_peak_memory_gb"] = {m: [r["compressed"]["trainer"][m]["peak_memory_gb"] for r in ranks]
                                             for m in COMPRESSED_METHODS[1:]}
    row = {"ranks": MESH_RANKS, "backend": r0["backend"], "trainer": r0["trainer"], "step_check": r0["step_check"],
           "b16384": r0["b16384"], "ls0.1": r0["ls0.1"], "index": r0["index"],
           "per_rank_data_s": [r["data_s"] for r in ranks], "ranks_s": ranks_s, "nccl_one_rank": cli,
           "cli_s": cli_s, "compressed": compressed}
    print("mesh " + json.dumps({k: v for k, v in row.items() if k != "compressed"}), flush=True)
    print("mesh_compressed " + json.dumps(compressed), flush=True)
    launches = {"mesh_trainer": r0["trainer"]["launches"], "mesh_b16384": r0["b16384"]["launches"],
                "mesh_ls0.1": r0["ls0.1"]["launches"], **cli_launches,
                **{f"mesh_compressed_{m}": r0["compressed"]["trainer"][m]["launches"] for m in COMPRESSED_METHODS},
                **{f"mesh_compressed_timed_{k}": v["launches"] for k, v in r0["compressed"]["timed"].items()}}
    return row, launches


# -- the large-table mesh: BASELINE config 3 row-sharded over two gloo ranks -------

MESH_ROWS_PATHS = ("mesh_scaled_dense", "mesh_scaled_sparse", "mesh_scaled_sparse_deferred",
                   "mesh_scaled_sparse_sampled")
MESH_ROWS_CHECK_STEPS = 2  # steps held against one device's, from one state
MESH_ROWS_TIMED_CALLS = 3  # of SCALED_CALL_STEPS steps (one deferred window each)
MESH_ROWS_LOSS_RTOL = {"dense": 1e-5, "sparse": 2e-5}
MESH_ROWS_LEAF_TOL = {"dense": (2e-4, 1e-6), "sparse": (2e-5, 1e-6)}  # (rtol, atol), tests/test_sharding.py,
# tests/test_sharded_sparse.py; the replicated leaves, after Adam steps in bf16 towers, take up to
# tests/test_torch_mesh_train.py's NOISE_SHARE of a leaf past it, none farther than 2 lr a step (Adam's
# first steps move an entry by about lr sign(g): a gradient at rounding noise steps by +-lr either way)
MESH_ROWS_NOISE_SHARE = 0.07
MESH_ROWS_SAMPLE_SEED = SEED + 23
MESH_ROWS_KERNELS = {  # launches per step on each rank
    "mesh_scaled_dense": {"embedding_lookup_pallas": 2, "dense_table_lookup": 0, "dense_table_grad": 0,
                          "fused_lean_lse": 1, "fused_ce_bwd": 1},
    "mesh_scaled_sparse": SCALED_KERNELS["scaled_sparse"],
}
MESH_ROWS_KERNELS["mesh_scaled_sparse_deferred"] = MESH_ROWS_KERNELS["mesh_scaled_sparse"]
MESH_ROWS_KERNELS["mesh_scaled_sparse_sampled"] = MESH_ROWS_KERNELS["mesh_scaled_sparse"]


def mesh_rows_config(path: str) -> TrainConfig:
    """Config 3's TrainConfig of ``path`` (``scaled_config``) with dropout 0,
    the row-sharded stores, and "auto" tables: above 65,536 rows it picks
    "gspmd_rows"."""
    base = scaled_config(path.replace("mesh_", "").replace("_sampled", ""))
    return base.replace(model=dataclasses.replace(base.model, dropout_rate=0.0),
                        mesh=dataclasses.replace(base.mesh, store_sharding="rows"))


def mesh_rows_steps(path: str, model, cfg, mesh, n: int, store_gather=None):
    """``call(state, batches_or_seed, pairs, n_store, c_store)``: n steps of
    ``path`` per call (one deferred window), on one device (mesh None) or
    on the rank's blocks (mesh, row-sharded stores through store_gather)."""
    tx = build_optimizer(cfg.optimizer, bench.TOTAL_STEPS)
    kw = dict(mesh=mesh, store_gather=store_gather)
    if path == "mesh_scaled_dense":
        steps = make_scanned_train_steps(model, cfg, tx, n, **kw)
    elif path == "mesh_scaled_sparse":
        steps = sparse_tables.make_scanned_sparse_steps(model, cfg, tx, bench.TOTAL_STEPS, n, **kw)
    elif path == "mesh_scaled_sparse_deferred":
        steps = sparse_tables.deferred_sparse_steps_fn(model, cfg, tx, bench.TOTAL_STEPS, n_inner=n, **kw)
    else:
        steps = sparse_tables.make_sampled_sparse_steps(model, cfg, tx, bench.TOTAL_STEPS, n, SCALED_BATCH, **kw)
        return lambda state, seed, pairs, ns, cs: steps(state, seed, pairs, ns, cs)
    return lambda state, idx, pairs, ns, cs: steps(state, idx, ns, cs)


def _leaf_blocks(state, keys, block) -> tuple[dict, dict]:
    """(the rank's block of each row-sharded leaf, each replicated leaf), as
    copies: a dense state's tables and accumulators, or a sparse state's."""
    if isinstance(state, sparse_tables.SparseTrainState):
        rows = {f"{f}.{leaf}": getattr(getattr(state, f), leaf) for f in sparse_tables.TABLE_KEYS.values()
                for leaf in ("table", "accumulator")}
        rep = {**state.dense_params, **state.batch_stats}
    else:
        rows = {**{k: state.params[k] for k in keys}, **{f"acc.{k}": state.opt_state["acc"][k] for k in keys}}
        rep = {**{k: v for k, v in state.params.items() if k not in keys}, **state.batch_stats}
    return ({k: v[block].clone() for k, v in rows.items()}, {k: v.clone() for k, v in rep.items()})


def untouched_rows_equal(model, host_stores, touched_pairs: np.ndarray, rows: dict, start_rows: dict,
                         dense: bool) -> bool:
    """Whether every row of this rank's table and accumulator blocks that no
    pair of ``touched_pairs`` looked up is bit-equal to its start."""
    ok = True
    for side, col in (("notice", 0), ("company", 1)):
        key = f"{side}_tower.embeddings.table"
        emb = getattr(model, f"{side}_tower").embeddings
        dev = emb.table.device
        ids = torch.from_numpy(host_stores[col][1].numpy()[touched_pairs[..., col].reshape(-1)]).to(dev)
        local, in_range = local_rows(emb._rows(ids).reshape(-1), emb.row_offset, emb.shard_rows)
        touched = torch.zeros(emb.shard_rows, dtype=torch.bool, device=dev)
        touched[local[in_range]] = True
        for name in ([key, f"acc.{key}"] if dense else [f"{side}_table.table", f"{side}_table.accumulator"]):
            changed = (rows[name] != start_rows[name]).reshape(emb.shard_rows, -1).any(1)
            ok &= not bool((changed & ~touched).any())
    return ok


def mesh_rows_path(mesh, path: str, schema, host_stores, pairs: np.ndarray) -> dict:
    """One path of the mesh_rows phase on this rank: config 3's full model
    drawn on the card from SEED (the same on every rank), one device's
    MESH_ROWS_CHECK_STEPS steps from it (one rank at a time, keeping this
    rank's block), then the mesh model cut from the same weights: the same
    steps held against them, the ranks' replicated leaves bit-equal, the
    rows no batch touched bit-equal to their start; then MESH_ROWS_TIMED_CALLS
    timed calls. Launches are counted from the first mesh step to the last."""
    dense = path == "mesh_scaled_dense"
    kind = "dense" if dense else "sparse"
    sampled = path.endswith("_sampled")
    cfg = mesh_rows_config(path)
    dev = mesh.device
    torch.manual_seed(SEED)  # the layers' and tables' draws, on the card alike in every rank
    with torch.device(dev):
        full = build_model(schema, cfg)
    start = full.state_dict()
    n_check, n_call = MESH_ROWS_CHECK_STEPS, SCALED_CALL_STEPS
    rng = np.random.default_rng(SEED + 21)
    batches = pairs[rng.integers(0, len(pairs), size=(n_check + n_call * MESH_ROWS_TIMED_CALLS, SCALED_BATCH))]
    pairs_dev = torch.from_numpy(pairs.astype(np.int64)).to(dev)

    def arg(lo: int, hi: int, state, block=slice(None)):
        if sampled:
            return MESH_ROWS_SAMPLE_SEED
        return torch.from_numpy(np.ascontiguousarray(batches[lo:hi, block])).to(dev)

    # -- one device, one rank at a time --------------------------------------------
    ref = None
    for r in range(mesh.size):
        mesh.barrier()
        if r == mesh.rank:
            stores = [tuple(x.to(dev) for x in st) for st in host_stores]
            state = (create_train_state(full, cfg, SEED, bench.TOTAL_STEPS, device=dev)[0] if dense
                     else sparse_tables.create_sparse_train_state(full, cfg, SEED, bench.TOTAL_STEPS, device=dev)[0])
            state, m = mesh_rows_steps(path, full, cfg, None, n_check)(state, arg(0, n_check, state), pairs_dev,
                                                                       *stores)
            table_rows = full.notice_tower.embeddings.total_rows
            ref = (m["loss"].cpu().numpy(), *_leaf_blocks(state, set(sparse_tables.TABLE_KEYS),
                                                           mesh.block(table_rows)))
            del state, stores, m
            torch.cuda.empty_cache()
    mesh.barrier()

    # -- the mesh ----------------------------------------------------------------------
    with torch.device(dev):
        model = build_model(schema, cfg, mesh)
    keys = model.row_sharded_keys
    check(keys == set(sparse_tables.TABLE_KEYS), f"{path}: tables not row-sharded ({sorted(keys)})")
    model.load_state_dict(shard_state(start, mesh, keys))
    del full, start
    torch.cuda.empty_cache()
    if dense:
        state, _, _, _, _, _ = make_sharded_indexed_train(model, cfg, mesh, SCALED_BATCH, bench.TOTAL_STEPS, n_inner=1)
    else:
        state, _, _, _ = make_sharded_sparse_train(model, cfg, mesh, SCALED_BATCH, bench.TOTAL_STEPS)
    store_gather, put_store = resolve_store_placement(cfg, mesh)
    n_store, c_store = (put_store(st) for st in host_stores)
    block = mesh.block(SCALED_BATCH)
    start_rows, _ = _leaf_blocks(state, keys, slice(None))
    check_steps = mesh_rows_steps(path, model, cfg, mesh, n_check, store_gather)
    call_steps = mesh_rows_steps(path, model, cfg, mesh, n_call, store_gather)
    # -- the main path: counters from 0, read right after ----------------------------
    reset_counters()
    torch.cuda.synchronize()
    state, m = check_steps(state, arg(0, n_check, state, block), pairs_dev, n_store, c_store)
    losses = m["loss"].cpu().numpy()
    rows, rep = _leaf_blocks(state, keys, slice(None))
    equal = ranks_equal(mesh, list(rep.values()))
    # rows of this rank's shards that no check batch touched: bit-equal to the start
    if sampled:
        drawn = [pairs_dev.index_select(0, torch.randint(
            0, len(pairs), (SCALED_BATCH,), generator=step_generator(dev, MESH_ROWS_SAMPLE_SEED, t, SAMPLE_STREAM),
            device=dev)).cpu().numpy() for t in range(n_check)]
        touched_pairs = np.stack(drawn)
    else:
        touched_pairs = batches[:n_check]
    untouched_ok = untouched_rows_equal(model, host_stores, touched_pairs, rows, start_rows, dense)
    emb = model.notice_tower.embeddings
    # against one device: the loss, this rank's blocks, the replicated leaves
    ref_losses, ref_rows, ref_rep = ref
    rtol, atol = MESH_ROWS_LEAF_TOL[kind]
    loss_rel = float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses)))
    worst_rows, worst_rep, share_rep = 0.0, 0.0, 0.0
    for name, want in ref_rows.items():
        excess = ((rows[name] - want).abs() - rtol * want.abs()).max()
        worst_rows = max(worst_rows, float(excess))
    for name, want in ref_rep.items():
        bad = ((rep[name] - want).abs() > atol + rtol * want.abs()).float().mean()
        share_rep = max(share_rep, float(bad))
        worst_rep = max(worst_rep, float((rep[name] - want).abs().max()))
    del ref, ref_rows, ref_rep, rows, start_rows
    # -- timed calls (the peak memory is theirs: the checks' copies are gone) -------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(MESH_ROWS_TIMED_CALLS):
        lo = n_check + c * n_call
        state, m = call_steps(state, arg(lo, lo + n_call, state, block), pairs_dev, n_store, c_store)
        timed_losses = m["loss"].cpu().numpy()
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = read_counters()
    n_steps = n_check + n_call * MESH_ROWS_TIMED_CALLS
    for name, per_step in MESH_ROWS_KERNELS[path].items():
        check(launches[name] == per_step * n_steps,
              f"{path} rank {mesh.rank}: kernel {name} launched {launches[name]} times in {n_steps} steps, "
              f"expected {per_step} per step")
    check(bool(np.isfinite(losses).all() and np.isfinite(timed_losses).all()), f"{path}: non-finite losses")
    check(equal, f"{path}: the ranks' replicated leaves differ after the check steps")
    check(untouched_ok, f"{path} rank {mesh.rank}: a row no batch touched changed")
    check(loss_rel <= MESH_ROWS_LOSS_RTOL[kind], f"{path}: loss {losses} vs one device {ref_losses}")
    check(worst_rows <= atol, f"{path} rank {mesh.rank}: table blocks differ from one device's by {worst_rows} "
                              f"past rtol {rtol}")
    rep_ok = share_rep <= MESH_ROWS_NOISE_SHARE and worst_rep <= 2 * n_check * cfg.optimizer.learning_rate
    check(rep_ok, f"{path} rank {mesh.rank}: replicated leaves differ from one device's ({share_rep} of a leaf "
                  f"past the tolerance, at most {worst_rep})")
    ms_per_step = timed_s * 1e3 / (n_call * MESH_ROWS_TIMED_CALLS)
    row = {"rank": mesh.rank, "batch": SCALED_BATCH, "rows_per_rank": SCALED_BATCH // mesh.size,
           "shard_rows": model.notice_tower.embeddings.shard_rows, "steps": n_steps, "ms_per_step": ms_per_step,
           "examples_per_sec": SCALED_BATCH * 1e3 / ms_per_step, "loss_check": losses.tolist(),
           "loss_one_device": ref_losses.tolist(), "loss_rel_err": loss_rel,
           "table_blocks_max_err_past_rtol": worst_rows, "replicated_max_abs_err": worst_rep,
           "replicated_share_past_tol": share_rep, "tolerance": {"rtol": rtol, "atol": atol},
           "ranks_equal": equal, "untouched_rows_equal": untouched_ok, "loss_last_call": float(timed_losses.mean()),
           "launches": launches, "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if dense:
        # the seconds to gather the row-sharded leaves of a config 3 checkpoint to rank 0, once
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rows_") as unused:
            t0 = time.perf_counter()
            payload = CheckpointManager(unused, mesh=mesh, sharded=keys).gathered_payload(state)
            row["checkpoint_gather_s"] = time.perf_counter() - t0
        if mesh.is_main:
            full_rows = payload["params"]["notice_tower.embeddings.table"].shape
            check(tuple(full_rows) == (emb.total_rows, SCALED_DIM), f"gathered table {full_rows}")
        del payload
    del state, model, n_store, c_store
    torch.cuda.empty_cache()
    return row


MESH_ROWS_INT16 = "mesh_scaled_sparse_int16"
MESH_ROWS_KERNELS[MESH_ROWS_INT16] = MESH_ROWS_KERNELS["mesh_scaled_sparse"]


def mesh_rows_int16_config() -> TrainConfig:
    """Config 3's sparse mesh (``mesh_rows_config``) under the int16 sync
    with global negatives, without BatchNorm, its stores replicated (the
    compressed steps feed every rank the whole stores, as the reference
    requires). The compressed steps take each rank's own BatchNorm
    statistics; without BatchNorm and with global negatives their loss is
    one device's, so the first loss and the table blocks after the first
    step (the exact exchange) hold against one device's."""
    base = mesh_rows_config("mesh_scaled_sparse")
    return base.replace(model=dataclasses.replace(base.model, use_batch_norm=False),
                        mesh=dataclasses.replace(base.mesh, store_sharding="replicated", grad_compression="int16",
                                                 compressed_negatives="global"))


def mesh_rows_int16_path(mesh, schema, host_stores, pairs: np.ndarray) -> dict:
    """The int16 path of the mesh_rows phase on this rank: one device's
    first step (one rank at a time, keeping this rank's blocks), then the
    compressed sparse steps (``make_dp_compressed_sparse_train``) from the
    same weights: the first loss within the sparse mesh's rtol of one
    device's, the table and accumulator blocks after it within the sparse
    gate, a second check step, the ranks' replicated leaves bit-equal and
    the rows no batch touched bit-equal to their start; then
    MESH_ROWS_TIMED_CALLS timed calls of SCALED_CALL_STEPS. Launches are
    counted from the first mesh step to the last."""
    path = MESH_ROWS_INT16
    cfg = mesh_rows_int16_config()
    dev = mesh.device
    torch.manual_seed(SEED)
    with torch.device(dev):
        full = build_model(schema, cfg)
    start = full.state_dict()
    n_check, n_call = MESH_ROWS_CHECK_STEPS, SCALED_CALL_STEPS
    rng = np.random.default_rng(SEED + 21)
    batches = pairs[rng.integers(0, len(pairs), size=(n_check + n_call * MESH_ROWS_TIMED_CALLS, SCALED_BATCH))]

    def arg(lo: int, hi: int, block=slice(None)):
        return torch.from_numpy(np.ascontiguousarray(batches[lo:hi, block])).to(dev)

    ref = None
    for r in range(mesh.size):
        mesh.barrier()
        if r == mesh.rank:
            stores = [tuple(x.to(dev) for x in st) for st in host_stores]
            state, tx = sparse_tables.create_sparse_train_state(full, cfg, SEED, bench.TOTAL_STEPS, device=dev)
            state, m = sparse_tables.make_scanned_sparse_steps(full, cfg, tx, bench.TOTAL_STEPS, 1)(state, arg(0, 1),
                                                                                                  *stores)
            table_rows = full.notice_tower.embeddings.total_rows
            ref = (float(m["loss"][0]), _leaf_blocks(state, set(), mesh.block(table_rows))[0])
            del state, stores, m
            torch.cuda.empty_cache()
    mesh.barrier()

    with torch.device(dev):
        model = build_model(schema, cfg, mesh)
    keys = model.row_sharded_keys
    check(keys == set(sparse_tables.TABLE_KEYS), f"{path}: tables not row-sharded ({sorted(keys)})")
    check(model.notice_tower.mesh is None, f"{path}: the towers take global statistics")
    model.load_state_dict(shard_state(start, mesh, keys))
    del full, start
    torch.cuda.empty_cache()
    built = compressed_grads.make_dp_compressed_sparse_train(model, cfg, mesh, SCALED_BATCH, bench.TOTAL_STEPS,
                                                             method="int16")
    state, err = built.state, built.err_state
    n_store, c_store = (built.put_store(st) for st in host_stores)
    block = mesh.block(SCALED_BATCH)
    start_rows, _ = _leaf_blocks(state, keys, slice(None))
    # -- the main path: counters from 0, read right after ----------------------------
    reset_counters()
    torch.cuda.synchronize()
    state, err, m = built.scan_steps(state, err, arg(0, 1, block), n_store, c_store)
    first_loss = float(m["loss"][0])
    after_first, _ = _leaf_blocks(state, keys, slice(None))
    state, err, m = built.scan_steps(state, err, arg(1, n_check, block), n_store, c_store)
    losses = [first_loss, *m["loss"].cpu().numpy().tolist()]
    rows, rep = _leaf_blocks(state, keys, slice(None))
    equal = ranks_equal(mesh, list(rep.values()))
    untouched_ok = untouched_rows_equal(model, host_stores, batches[:n_check], rows, start_rows, False)
    ref_loss, ref_rows = ref
    rtol, atol = MESH_ROWS_LEAF_TOL["sparse"]
    loss_rel = abs(first_loss - ref_loss) / abs(ref_loss)
    worst_rows = max(float(((after_first[k] - want).abs() - rtol * want.abs()).max()) for k, want in ref_rows.items())
    del ref, ref_rows, rows, start_rows, after_first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(MESH_ROWS_TIMED_CALLS):
        lo = n_check + c * n_call
        state, err, m = built.scan_steps(state, err, arg(lo, lo + n_call, block), n_store, c_store)
        timed_losses = m["loss"].cpu().numpy()
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = read_counters()
    n_steps = n_check + n_call * MESH_ROWS_TIMED_CALLS
    for name, per_step in MESH_ROWS_KERNELS[path].items():
        check(launches[name] == per_step * n_steps,
              f"{path} rank {mesh.rank}: kernel {name} launched {launches[name]} times in {n_steps} steps, "
              f"expected {per_step} per step")
    check(bool(np.isfinite(losses).all() and np.isfinite(timed_losses).all()), f"{path}: non-finite losses")
    check(equal, f"{path}: the ranks' replicated leaves differ after the check steps")
    check(untouched_ok, f"{path} rank {mesh.rank}: a row no batch touched changed")
    check(loss_rel <= MESH_ROWS_LOSS_RTOL["sparse"], f"{path}: first loss {first_loss} vs one device {ref_loss}")
    check(worst_rows <= atol, f"{path} rank {mesh.rank}: table blocks after the first step differ from one "
                              f"device's by {worst_rows} past rtol {rtol}")
    ms_per_step = timed_s * 1e3 / (n_call * MESH_ROWS_TIMED_CALLS)
    row = {"rank": mesh.rank, "batch": SCALED_BATCH, "rows_per_rank": SCALED_BATCH // mesh.size,
           "shard_rows": model.notice_tower.embeddings.shard_rows, "steps": n_steps, "ms_per_step": ms_per_step,
           "examples_per_sec": SCALED_BATCH * 1e3 / ms_per_step, "loss_check": losses, "loss_one_device": ref_loss,
           "loss_rel_err": loss_rel, "table_blocks_max_err_past_rtol": worst_rows,
           "tolerance": {"rtol": rtol, "atol": atol}, "ranks_equal": equal, "untouched_rows_equal": untouched_ok,
           "loss_last_call": float(timed_losses.mean()), "launches": launches,
           "wire_bytes_per_rank": compressed_grads.ring_wire_bytes(built.sync.buffers, mesh.size),
           "dense_params": int(sum(v.numel() for v in err.values())),
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del state, err, built, model, n_store, c_store
    torch.cuda.empty_cache()
    return row


def mesh_rows_rank(devices: list) -> dict:
    """One rank of the mesh_rows phase: config 3's data built from its seed
    on the host, then every path of MESH_ROWS_PATHS. Any failed check
    raises, which fails the launch."""
    mesh = make_mesh(devices)
    torch.cuda.set_device(mesh.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    schema, ds = scaled_dataset()
    dtype = resolve_store_dtype(mesh_rows_config("mesh_scaled_dense"))
    host_stores = [host_store(fs, dtype) for fs in (ds.notice_store, ds.company_store)]
    out = {"rank": mesh.rank, "backend": mesh.backend, "data_s": time.perf_counter() - t0}
    for path in (*MESH_ROWS_PATHS, MESH_ROWS_INT16):
        t1 = time.perf_counter()
        if path == MESH_ROWS_INT16:
            out[path] = mesh_rows_int16_path(mesh, schema, host_stores, ds.pairs)
        else:
            out[path] = mesh_rows_path(mesh, path, schema, host_stores, ds.pairs)
        out[path]["path_s"] = time.perf_counter() - t1
        print(f"mesh_rows rank {mesh.rank} {path} " + json.dumps(out[path]), flush=True)
    return out


def mesh_rows_phase() -> tuple[dict, dict]:
    """MESH_RANKS gloo ranks on the one card (``mesh_rows_rank``), through
    the port's launcher with its group timeout and deadline: BASELINE config
    3 with its tables and stores row-sharded. Returns the record and rank
    0's launches per path."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(mesh_rows_rank, MESH_RANKS, args=(["cuda:0"] * MESH_RANKS,), backend="gloo",
                   devices=["cuda:0"] * MESH_RANKS, timeout_s=MESH_PG_S, join_timeout_s=MESH_JOIN_S)
    ranks_s = time.perf_counter() - t0
    paths = (*MESH_ROWS_PATHS, MESH_ROWS_INT16)
    for path in paths:
        check(ranks[0][path]["loss_check"] == ranks[1][path]["loss_check"], f"{path}: the ranks' losses differ")
    row = {"ranks": MESH_RANKS, "backend": ranks[0]["backend"], "ranks_s": ranks_s,
           "per_rank_data_s": [r["data_s"] for r in ranks], **{path: [r[path] for r in ranks] for path in paths}}
    print("mesh_rows " + json.dumps(row), flush=True)
    return row, {path: ranks[0][path]["launches"] for path in paths}


# -- a model axis above 1: four gloo ranks on the card as a (2, 2) mesh --------------

MESH_MODEL_RANKS = 4
MESH_MODEL_AXES = MeshConfig(data_axis=2, model_axis=2)
MESH_MODEL_STEPS = 2  # sampled steps, then one eval batch, from one state
MESH_MODEL_SAMPLE_SEED = SEED + 41


def state_digest(state) -> str:
    """sha256 of every param, BatchNorm statistic and optimizer leaf's bytes,
    in key order: two ranks hold the same state iff their digests agree."""
    h = hashlib.sha256()
    leaves = {**state.params, **state.batch_stats,
              **{f"opt.{k}.{n}": v for k, tree in state.opt_state.items() if isinstance(tree, dict)
                 for n, v in tree.items() if isinstance(v, torch.Tensor)}}
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(leaves[k].detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_model_run(mesh, schema, ds, stores, pairs_dev, eval_idx) -> dict:
    """MESH_MODEL_STEPS sampled steps at global B = CE_BATCH from the seeded
    state, then one eval batch of ``eval_idx`` (each rank its data index's
    block): the losses, the eval metrics and the state's digest, and the
    launches (counters from 0 just before, read just after)."""
    cfg = mesh_config(CE_BATCH)
    model = build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(SEED))
    state, tx = create_train_state(model, cfg, SEED, bench.TOTAL_STEPS, device=mesh.device)
    steps = make_sampled_train_steps(model, cfg, tx, MESH_MODEL_STEPS, CE_BATCH, mesh=mesh)
    evaluate = make_indexed_eval_steps(model, cfg, mesh=mesh)
    # -- the main path: counters from 0, read right after ----------------------
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = steps(state, MESH_MODEL_SAMPLE_SEED, pairs_dev, *stores)
    ev = evaluate(state, eval_idx, *stores)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    return {"losses": metrics["loss"].tolist(), "eval": {k: float(v[0]) for k, v in ev.items()},
            "digest": state_digest(state), "wall_s": wall_s, "launches": launches,
            "rows_per_rank": CE_BATCH // mesh.size}


def mesh_model_rank(devices: list) -> dict:
    """One of four gloo ranks on the card: the bench's data from its seed,
    then ``mesh_model_run`` on the (2, 2) mesh twice (the first warms the
    process up; the two must agree bit for bit) and, on ranks 0 and 1, on a
    (2, 1) mesh of those two. The group of ranks 0 and 1 is created by every
    rank, as ``new_group`` asks."""
    import torch.distributed as dist

    pair_group = dist.new_group([0, 1])
    mesh = make_mesh(devices, MESH_MODEL_AXES)
    torch.cuda.set_device(mesh.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    schema = reference_shaped_schema()
    ds = make_synthetic_dataset(schema, n_notices=bench.N_NOTICES, n_companies=bench.N_COMPANIES,
                                n_pairs=bench.N_PAIRS, n_clusters=bench.N_CLUSTERS, seed=SEED)
    cfg = mesh_config(CE_BATCH)
    stores = [device_store(st, dtype=resolve_store_dtype(cfg), device=mesh.device)
              for st in (ds.notice_store, ds.company_store)]
    pairs_dev = torch.from_numpy(ds.pairs.astype(np.int64)).to(mesh.device)
    rng = np.random.default_rng(SEED + 43)
    eval_idx = torch.from_numpy(ds.pairs[rng.integers(0, len(ds.pairs), size=CE_BATCH)][None].astype(np.int64))
    eval_idx = eval_idx.to(mesh.device)
    out = {"rank": dist.get_rank(), "data_index": mesh.rank, "model_index": mesh.model_index,
           "shape": dict(mesh.shape), "is_main": mesh.is_main, "backend": mesh.backend,
           "data_s": time.perf_counter() - t0}
    # the first run in each process pays its warm-up (cuBLAS, the kernels'
    # modules, gloo's buffers); the second, from a fresh state, is the one read
    warm = mesh_model_run(mesh, schema, ds, stores, pairs_dev, eval_idx)
    out["mesh22"] = mesh_model_run(mesh, schema, ds, stores, pairs_dev, eval_idx)
    out["mesh22"]["warmup_wall_s"] = warm["wall_s"]
    check(warm["digest"] == out["mesh22"]["digest"], f"mesh_model rank {out['rank']}: two runs from one state differ")
    print(f"mesh_model rank {out['rank']} (2, 2) " + json.dumps(out["mesh22"]), flush=True)
    if out["rank"] < 2:
        mesh21 = make_mesh(devices[:2], MeshConfig(), group=pair_group)
        out["mesh21"] = mesh_model_run(mesh21, schema, ds, stores, pairs_dev, eval_idx)
        print(f"mesh_model rank {out['rank']} (2, 1) " + json.dumps(out["mesh21"]), flush=True)
    return out


def mesh_model_phase() -> tuple[dict, dict]:
    """MESH_MODEL_RANKS gloo ranks on the one card, through the port's
    launcher: the (2, 2) mesh's steps and eval batch bit-equal across the
    model axis (the two ranks of each data index: losses, eval metrics,
    state digests) and to the (2, 1) mesh's rank of the same data index;
    launches exact on every rank (``step_launches`` of the steps and the
    eval batch, each on its data index's 4096 rows)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(mesh_model_rank, MESH_MODEL_RANKS, args=(["cuda:0"] * MESH_MODEL_RANKS,), backend="gloo",
                   devices=["cuda:0"] * MESH_MODEL_RANKS, timeout_s=MESH_PG_S, join_timeout_s=MESH_JOIN_S)
    ranks_s = time.perf_counter() - t0
    expected = step_launches(MESH_MODEL_STEPS, 1)
    for r, rank in enumerate(ranks):
        check((rank["data_index"], rank["model_index"]) == (r // 2, r % 2) and rank["is_main"] == (r == 0)
              and rank["shape"] == {"data": 2, "model": 2}, f"mesh_model: rank {r} sits at {rank}")
        for mesh_name in ("mesh22", "mesh21") if r < 2 else ("mesh22",):
            check_launches(rank[mesh_name]["launches"], expected, f"mesh_model rank {r} {mesh_name}")
        want = ranks[r // 2]["mesh21"]
        for key in ("losses", "eval", "digest"):
            check(rank["mesh22"][key] == want[key],
                  f"mesh_model: rank {r}'s (2, 2) {key} differs from the (2, 1) rank {r // 2}'s")
    check(bool(np.isfinite(ranks[0]["mesh22"]["losses"]).all()), "mesh_model: non-finite loss")
    row = {"ranks": MESH_MODEL_RANKS, "axes": {"data": 2, "model": 2}, "backend": ranks[0]["backend"],
           "ranks_s": ranks_s, "per_rank_data_s": [r["data_s"] for r in ranks], "batch": CE_BATCH,
           "rows_per_data_index": CE_BATCH // 2, "losses": ranks[0]["mesh22"]["losses"],
           "eval": ranks[0]["mesh22"]["eval"], "bit_equal_across_model_axis": True, "bit_equal_to_2x1": True,
           "wall_s": {"mesh22": [r["mesh22"]["wall_s"] for r in ranks],
                      "mesh22_warmup": [r["mesh22"]["warmup_wall_s"] for r in ranks],
                      "mesh21": [r["mesh21"]["wall_s"] for r in ranks[:2]]},
           "ms_per_step_incl_eval": ranks[0]["mesh22"]["wall_s"] * 1e3 / MESH_MODEL_STEPS,
           "examples_per_sec": MESH_MODEL_STEPS * CE_BATCH / ranks[0]["mesh22"]["wall_s"],
           "launches": ranks[0]["mesh22"]["launches"]}
    print("mesh_model " + json.dumps(row), flush=True)
    return row, {"mesh_model": ranks[0]["mesh22"]["launches"]}


# -- the JAX package's scripts, ported: the multihost smoke, the mesh scripts,
#    the one-device studies and BASELINE config 2's demo ----------------------------


def cli_json(stdout: str) -> list[dict]:
    """The JSON lines a script printed."""
    return [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]


def multihost_phase() -> tuple[dict, dict]:
    """``python -m jodalrob_twotower_torch.multihost_smoke`` in-process: two
    processes sharing the card over gloo, the streaming leg fed from memory
    (the card machine has no pyarrow); the script checks every leg of the
    reference's and raises on a failure, also where the compressed
    Trainer's launches on any process differ from K2 twice a step and
    nothing else (replicated tables of embed width 8 under float32 towers:
    the dense table gradient behind the gather, as the reference's "auto"
    takes it). Returns the summary and rank 0's launches on that leg."""
    t0 = time.perf_counter()
    stdout, _ = run_cli(multihost_smoke.main, ["--processes", 2])
    out = cli_json(stdout)[-1]
    check(out["bench"] == "multihost_smoke" and out["ok"] is True, f"multihost_smoke: {out}")
    out["phase_s"] = time.perf_counter() - t0
    return out, {"multihost_compressed": out["compressed_launches"]}


def mesh_scripts_phase() -> tuple[dict, dict]:
    """The mesh scripts in-process, two ranks sharing the card over gloo:
    ``sharded_serving_bench`` (the recall of exact and int8 equal to one
    device's but at ties, the rescore's no lower), ``rowsharded_store_bench``
    (the modes' losses bit-equal, "rows" holding 1/2 of the padded rows a
    rank) and ``scaling_sweep`` at 1 and 2 ranks (the mesh of one in this
    process: its timed steps' launches are read from the counters, K1 and
    K2 twice a step and nothing else). Each script raises on a failed
    check of its own."""
    out, launches = {}, {}
    t0 = time.perf_counter()
    stdout, _ = run_cli(sharded_serving_bench.main, ["--ranks", 2])
    out["sharded_serving"] = {row["bench"].rsplit("_mesh_", 1)[1]: row for row in cli_json(stdout)}
    out["sharded_serving"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stdout, _ = run_cli(rowsharded_store_bench.main, ["--ranks", 2])
    rows, replicated, compare = cli_json(stdout)
    check(rows["store_rows_per_rank"] == rowsharded_store_bench.N_ROWS // 2 and compare["losses_equal"],
          f"rowsharded_store_bench: {compare}")
    out["rowsharded_store"] = {"rows": rows, "replicated": replicated, "compare": compare,
                               "phase_s": time.perf_counter() - t0}
    launches["rowsharded_store_rows"] = rows["launches"]
    launches["rowsharded_store_replicated"] = replicated["launches"]
    t0 = time.perf_counter()
    reset_counters()
    stdout, _ = run_cli(scaling_sweep.main, ["--devices", 1, 2])
    sweep = cli_json(stdout)
    counted = read_counters()  # the mesh of one ran here; the two ranks count in their own processes
    n = scaling_sweep.STEPS + 1  # the warm-up and the timed steps
    check_launches(counted, {**step_launches(n), "fused_lean_lse": 0, "fused_ce_bwd": 0}, "scaling_sweep one device")
    check(all(np.isfinite(r["loss"]) for r in sweep), f"scaling_sweep: {sweep}")
    out["scaling_sweep"] = {"rows": sweep, "phase_s": time.perf_counter() - t0}
    launches["scaling_sweep"] = sweep[0]["launches"]
    launches["scaling_sweep_2_ranks_rank0"] = sweep[1]["launches"]
    return out, launches


def studies_phase() -> tuple[dict, dict]:
    """The one-device studies in-process: ``onehot_rowsharded_study`` (K1 at
    (R, B), (R/8, B), (R, B/8)), ``embgrad_microbench`` (K2 against K3: K3's
    first driven path), ``topk_microbench`` (plain PyTorch but for the
    scan's top-k kernel) and ``scatter_microbench`` (plain PyTorch; each
    scatter variant held to its group's first). The counters run from 0
    across each script: K1 on the study, K2 and K3 on the embgrad
    microbench, the top-k kernel on the top-k one, exactly as their
    warm-up, check and timed launches ask; none on the plain ones."""
    out, launches = {}, {}
    for name, module, expect in (
            ("onehot_study", onehot_rowsharded_study,
             {"dense_table_lookup": len(onehot_rowsharded_study.SHAPES) * (onehot_rowsharded_study.RUNS + 2)}),
            ("embgrad", embgrad_microbench, {"dense_table_grad": embgrad_microbench.RUNS + 2,
                                             "dense_table_grad_bmajor": embgrad_microbench.RUNS + 2}),
            ("topk", topk_microbench, {"chunk_topk": topk_microbench.kernel_launches_per_run()}),
            ("scatter", scatter_microbench, {})):
        t0 = time.perf_counter()
        reset_counters()
        stdout, _ = run_cli(module.main, [])
        counted = read_counters()
        check_launches(counted, {k: expect.get(k, 0) for k in counted}, name)
        out[name] = {"rows": cli_json(stdout), "phase_s": time.perf_counter() - t0}
        launches[name] = counted
    return out, launches


REFERENCE_CONFIGS = {  # of the form tests/test_reference_configs.py uses
    "numeric": {"num_0": {"fill": "median", "log1p": True, "scale": "zscore", "add_flag": True, "clip": [0.5, 99.5]},
                "num_1": {"fill": 0, "log1p": False, "scale": "none", "add_flag": True, "clip_abs": [0.0, 100.0]},
                "num_2": {"fill": "mode", "log1p": False, "scale": "none", "add_flag": True}},
    "categorical": {"cat_0": {"encoding_method": "label"},
                    "cat_1": {"encoding_method": "label", "rare_threshold": 0.5}},
    "text": {"bidntcenm": {"use": True, "embedding_model": "some/model", "max_length": 32, "normalize": True,
                           "add_flag": True, "null_strategy": "empty"}},
}
REFERENCE_DEMO_ROWS, REFERENCE_DEMO_PAIRS, REFERENCE_DEMO_BATCH = 20_000, 100_000, 256  # the demo's defaults


def reference_scale_phase() -> tuple[dict, dict]:
    """``python -m jodalrob_twotower_torch.reference_scale_demo`` at its
    defaults (20,000 rows a side, 100,000 pairs, one epoch at B = 256) on a
    metadata directory written here in the reference's format
    (``etl_metadata_csv``, the configs of REFERENCE_CONFIGS): the
    reference's schema, the trainer with its corpus eval; launches exact
    (``trainer_launches`` at B = 256), the metrics finite and validation
    recall@10 above random."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_reference_"))
    try:
        meta = tmp / "meta"
        meta.mkdir()
        etl_metadata_csv(meta / "metadata.csv")
        for name, cfg in REFERENCE_CONFIGS.items():
            (meta / f"notice_{name}_config.json").write_text(json.dumps(cfg))
        t0 = time.perf_counter()
        # -- the main path: counters from 0, read right after ----------------------
        reset_counters()
        stdout, _ = run_cli(reference_scale_demo.main, ["--meta", meta, "--workdir", tmp / "work"])
        launches = read_counters()
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("schema: notice 29 num / 32 cat / 1 text; company 1 / 6 / 0" in stdout,
          "reference_scale_demo: not the reference's schema")
    out = cli_json(stdout)[-1]
    n_val = min(REFERENCE_DEMO_PAIRS // 5, 4096)
    check_launches(launches, trainer_launches(1, REFERENCE_DEMO_PAIRS - REFERENCE_DEMO_PAIRS // 5, n_val,
                                              REFERENCE_DEMO_ROWS, REFERENCE_DEMO_BATCH), "reference_scale_demo")
    check(bool(np.isfinite([out["mrr"], out["auc"], out["recall@10"], out["corpus_mrr"]]).all())
          and out["recall@10"] > 10 / REFERENCE_DEMO_BATCH, f"reference_scale_demo: {out}")
    out.update(wall_s=wall_s, launches=launches)
    return out, {"reference_scale": launches}


def kernel_record(name: str, tpu_kernel: str, source: str, replaces: str, rows: list[dict], launches: dict,
                  counter: str, path: str) -> dict:
    """The record of one TPU kernel's port: ``launches`` counts the wrapper
    ``counter`` on the driven ``path`` that runs this kernel at its shape (0
    for a kernel no path runs, ``path`` None); ms, plain_ms, library_ms and
    the bound come from the first case."""
    main = rows[0]
    rec = {
        "name": name, "tpu_kernel": tpu_kernel, "route": "cuda", "source": f"jodalrob_twotower_torch/csrc/{source}",
        "replaces": f"jodalrob_twotower_tpu/ops/{replaces}", "launches": launches[path][counter] if path else 0,
        "launches_path": path, "launches_by_path": {p: counts[counter] for p, counts in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"], "main_case": main["case"], "cases": rows,
    }
    if "equal" in main:
        rec["equal"] = all(r["equal"] for r in rows)
    for key in ("two_calls_equal", "equal_to_k2_transposed"):
        if key in main:
            rec[key] = all(r[key] for r in rows)
    return rec


TITLE_BATCH = 256  # titles a search, as the benchmark's title cell sends them
TITLE_CORPUS = 1_000_000


def title_schema() -> TwoTowerSchema:
    """The reference's notice tower with its title encoded by kanana2 at the
    published widths (max_length 32), the company tower as it is."""
    base = reference_shaped_schema()
    notice = dataclasses.replace(base.notice, text=(), encoded_text=(EncodedTextSpec("bidntcenm"),))
    return TwoTowerSchema(notice=notice, company=base.company)


def moe_kernel_checks(gen: torch.Generator, flush: torch.Tensor) -> list[dict]:
    """The four dispatch kernels against their plain versions at the
    published widths: a router's choices over the 8,192 slots of 256 titles
    of 32 positions, of which about two thirds are real tokens; each timed
    (median of 20, CUDA events)."""
    t_, h, i, e, k = 8192, 2048, 768, 128, 6
    valid = torch.rand(t_, generator=gen, device="cuda") < 0.66
    x = torch.randn(t_, h, generator=gen, device="cuda").bfloat16()
    s = torch.sigmoid(torch.randn(t_, e, generator=gen, device="cuda"))
    chosen = torch.topk(s, k, dim=-1).indices
    w = s.gather(1, chosen)
    w = (w / w.sum(-1, keepdim=True) * 2.448).reshape(-1).contiguous()
    ids = torch.where(valid[:, None], chosen, e).int().reshape(-1).contiguous()
    tally, tally_plain = (torch.zeros(e, 2, dtype=torch.int64, device="cuda") for _ in range(2))
    sorted_ = moe.sort_pairs(ids, e, tally)
    plain = moe.sort_pairs_plain(ids, e, tally_plain)
    check(all(torch.equal(a, b) for a, b in zip(sorted_, plain)) and torch.equal(tally, tally_plain),
          "moe sort_pairs differs from its plain version")
    perm, inv, counts, offsets = sorted_
    real = int(counts[:e].sum())
    w_gu = (torch.randn(e, 2 * i, h, generator=gen, device="cuda") * h ** -0.5).bfloat16()
    w_d = (torch.randn(e, h, i, generator=gen, device="cuda") * i ** -0.5).bfloat16()
    hh, hh_plain = moe.grouped_gate_up(x, w_gu, perm, counts, offsets, k), moe.grouped_gate_up_plain(
        x, w_gu, perm, counts, offsets, k)
    y, y_plain = moe.grouped_down(hh_plain, w_d, perm, counts, offsets, w), moe.grouped_down_plain(
        hh_plain, w_d, perm, counts, offsets, w)
    shared, resid = (torch.randn(t_, h, generator=gen, device="cuda").bfloat16() for _ in range(2))
    out, out_plain = moe.combine(y_plain, inv, ids, shared, resid, e), moe.combine_plain(y_plain, inv, ids, shared,
                                                                                       resid, e)

    def rel(a, b):
        return float((a[:real].float() - b[:real].float()).norm() / b[:real].float().norm())

    rows = [{"kernel": "moe_sort", "equal": True},
            {"kernel": "moe_gate_up", "rel_err": rel(hh, hh_plain), "tol": 4e-3},
            {"kernel": "moe_down", "rel_err": rel(y, y_plain), "tol": 4e-3},
            {"kernel": "moe_combine", "equal": bool(torch.equal(out, out_plain))}]
    for r in rows:
        check(r.get("equal", True) and r.get("rel_err", 0.0) <= r.get("tol", 0.0), f"{r['kernel']} {r}")
    flops_pair = 6 * h * i
    calls = {"moe_sort": (lambda: moe.sort_pairs(ids, e, tally), bound(0, real * 12)),
             "moe_gate_up": (lambda: moe.grouped_gate_up(x, w_gu, perm, counts, offsets, k),
                             bound(real * flops_pair * 2 / 3, e * 2 * i * h * 2 + real * (h + i) * 2)),
             "moe_down": (lambda: moe.grouped_down(hh, w_d, perm, counts, offsets, w),
                          bound(real * flops_pair / 3, e * h * i * 2 + real * (h + i) * 2)),
             "moe_combine": (lambda: moe.combine(y, inv, ids, shared, resid, e),
                             bound(0, t_ * (k * 8 + 6 * h) + real * h * 2))}
    for r in rows:
        fn, cost = calls[r["kernel"]]
        r.update(ms=median_ms(fn, flush, runs=20), pairs=real, **cost)
    return rows


@contextlib.contextmanager
def plain_dispatch():
    """The encoder's kernels swapped for their plain versions while open."""
    swaps = [(moe, n, getattr(moe, f"{n}_plain")) for n in ("sort_pairs", "grouped_gate_up", "grouped_down", "combine")]
    kept = [getattr(mod, n) for mod, n, _ in swaps]
    try:
        for mod, n, f in swaps:
            setattr(mod, n, f)
        yield
    finally:
        for (mod, n, _), f in zip(swaps, kept):
            setattr(mod, n, f)


def encoder_layer_check(encoder, ids: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Layer 1's MoE block on the titles' own hidden states, the kernels
    against the plain dispatch on the same input (one routing, so the two
    differ by bf16 rounding alone): the share of the block's output norm by
    which they differ."""
    c = encoder.config
    b, n = ids.shape
    eps = c.rms_norm_eps
    valid = (torch.arange(n, device="cuda")[None, :] < lengths[:, None]).reshape(-1)
    cos, sin = rope_tables(n, c.qk_rope_head_dim, c.rope_theta, "cuda")
    l0, l1 = encoder.layers[0], encoder.layers[1]
    x = el.embedding_lookup_pallas(encoder.embed_tokens.weight, ids.reshape(-1))
    x = x + encoder._attention(l0.self_attn, text_encoder_mod.rms_norm(x, l0.input_layernorm.weight, eps), b, cos, sin)
    x = x + text_encoder_mod._swiglu(l0.mlp, text_encoder_mod.rms_norm(x, l0.post_attention_layernorm.weight, eps))
    x = x + encoder._attention(l1.self_attn, text_encoder_mod.rms_norm(x, l1.input_layernorm.weight, eps), b, cos, sin)
    h = text_encoder_mod.rms_norm(x, l1.post_attention_layernorm.weight, eps)
    tally = torch.zeros(c.n_routed_experts, 2, dtype=torch.int64, device="cuda")
    zero = torch.zeros_like(x)  # the block's own output, not rounded at the residual's scale
    out = encoder._moe(l1.mlp, h, zero, valid, tally).float()
    with plain_dispatch():
        out_plain = encoder._moe(l1.mlp, h, zero, valid, tally).float()
    row = {"moe_rel": float((out - out_plain).norm() / out_plain.norm()), "tol": 0.01}
    check(row["moe_rel"] <= row["tol"], f"encoder layers {row}")
    return row


def text_encoder_phase() -> dict:
    """kanana2 at its published widths (48 layers, 128 experts, bf16, seeded
    random weights) inside the notice tower: the dispatch kernels against
    their plain versions, then ``search_device`` over an int8 index of 1M
    companies with 256-title batches; one attention and one MoE block of the
    model against the plain dispatch (gated), the pooled titles against it
    (recorded), launches per search counted, the card's time a search and
    the peak memory."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    kernels = moe_kernel_checks(gen, flush)
    print("text_encoder kernels " + json.dumps(kernels), flush=True)
    cfg = TrainConfig()
    with torch.device("meta"):
        model = build_model(title_schema(), cfg)
    model.to_empty(device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".encoder_" not in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") / math.sqrt(p.shape[-1]))
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen, device="cuda") + 0.5 if name.endswith("var")
                    else 0.1 * torch.randn(b.shape, generator=gen, device="cuda"))
    encoder = model.notice_tower.encoder_bidntcenm
    enc_cfg = dataclasses.asdict(encoder.config)  # the HF keys the benchmark's draw reads
    with torch.no_grad():
        enc_params = dict(encoder.named_parameters())
        for piece in gen_kanana.pieces(enc_cfg):
            for name, v in gen_kanana.draw(enc_cfg, SEED, piece, "cuda").items():
                enc_params[name].copy_(v)
                del v
    encoder_gb = sum(p.numel() * p.element_size() for p in encoder.parameters()) / 1e9
    state = FrozenState(dict(model.state_dict()))
    corpus = torch.nn.functional.normalize(torch.randn(TITLE_CORPUS, 128, generator=gen, device="cuda"), dim=1)
    svc = RetrievalService(model, cfg, state, None, index_kind="int8", corpus_chunk=262_144, rescore_depth=400,
                           rescore_dtype="bfloat16", precomputed_corpus_emb=corpus)
    del corpus
    ids = torch.randint(0, encoder.config.vocab_size, (TITLE_BATCH, 32), generator=gen, device="cuda",
                        dtype=torch.int32)
    lengths = torch.randint(6, 33, (TITLE_BATCH,), generator=gen, device="cuda", dtype=torch.int32)
    batch = TowerBatch(torch.randn(TITLE_BATCH, 29, generator=gen, device="cuda"),
                       torch.randint(0, 1000, (TITLE_BATCH, 32), generator=gen, device="cuda", dtype=torch.int32),
                       ids, lengths)
    res = svc.search(batch, 100)  # warm: Triton compiles the combine once
    torch.cuda.synchronize()
    before_moe, before_k4 = moe.launches(), el.embedding_lookup_pallas.launches
    svc.search_device(batch, 100)
    torch.cuda.synchronize()
    per_search = {k: v - before_moe[k] for k, v in moe.launches().items()}
    per_search["embedding_lookup_pallas"] = el.embedding_lookup_pallas.launches - before_k4
    n_moe = encoder.config.n_moe_layers
    want = {"sort_pairs": 2 * n_moe, "grouped_gate_up": n_moe, "grouped_down": n_moe, "combine": n_moe,
            "embedding_lookup_pallas": 1}
    check(per_search == want, f"text encoder launches per search {per_search}, want {want}")
    check(np.isfinite(res.scores).all() and (np.diff(res.scores, axis=1) <= 0).all(), "title search scores")
    with torch.inference_mode():
        layer_check = encoder_layer_check(encoder, ids, lengths)
        pooled = encoder(ids, lengths)
        with plain_dispatch():
            pooled_plain = encoder(ids, lengths)
    diff = ((pooled - pooled_plain).norm(dim=1) / pooled_plain.norm(dim=1)).cpu()
    search_ms = median_ms(lambda: svc.search_device(batch, 100), flush, runs=10)
    encode_ms = median_ms(lambda: encoder(ids, lengths), flush, runs=10)
    out = {"encoder_gb": encoder_gb, "kernels": kernels, "launches_per_search": per_search,
           "layer_check": layer_check,
           # recorded, not gated: after 48 layers a bf16 rounding and a routing near-tie
           # apart move a title's vector by a share its weights set (PERF.md section 2)
           "pooled_vs_plain_rel": {"median": float(diff.median()), "max": float(diff.max())},
           "search_ms": search_ms, "encode_ms": encode_ms, "queries_per_s": TITLE_BATCH / search_ms * 1e3,
           "tokens": int(lengths.sum()), "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "phase_s": time.perf_counter() - t0}
    del svc, state, model, encoder, flush
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    card = bench.card_line()
    print(card, flush=True)  # name, power limit: every number below is this card's
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        _build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {KERNEL_SOURCES}", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", flush=True)
    # the CE builds: registers (the consumers raise theirs to 232 with
    # setmaxnreg), shared memory and spills; none may spill, and the
    # forward's wgmma must not be serialized
    bwd_build = {"functions": ptxas_report(logs.get("fused_ce_bwd", "")),
                 "dynamic_smem_bytes": {d: fl._bwd_lib().fused_ce_bwd_smem_bytes(d) for d in (128, 256, 384, 512)}}
    print("ptxas fused_ce_bwd " + json.dumps(bwd_build), flush=True)
    check(all(f.get("spill_store_bytes", 0) == 0 == f.get("spill_load_bytes", 0) for f in bwd_build["functions"]),
          f"fused_ce_bwd spills: {bwd_build['functions']}")
    fwd_build = fwd_build_report()
    stats_build = stats_build_report()
    lookup_build = build_report("onehot_lookup")
    gather_build = build_report("row_gather")
    topk_build = build_report("chunk_topk")
    build_report("moe_dispatch")
    build_report("int8_scan", {d: i8._lib().int8_scan_smem_bytes(d) for d in (32, 128, 512, 1024)})

    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    kernels = kernel_phase(flush)
    del flush
    serving = serving_phase()
    serving["card"] = card
    print("serving " + json.dumps(serving), flush=True)
    training, work = training_phase()
    training["card"] = card
    print("training " + json.dumps(training), flush=True)
    evaluation, eval_launches = evaluation_phase(work)
    evaluation["card"] = card
    print("evaluation " + json.dumps(evaluation), flush=True)
    extra, extra_launches = extra_training_phase(work)
    headline_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_headline_"))
    try:
        headline, headline_counts = headline_phase(training, headline_dir)
        serve_cli, serve_launches = serve_cli_phase(headline_dir / "run")
    finally:
        shutil.rmtree(headline_dir, ignore_errors=True)
    resume, resume_launches = resume_phase(work)
    profile, profile_launches = profile_phase(work)
    hostfed, hostfed_launches_by_path = hostfed_phase(work)
    hostfed["card"] = card
    print("hostfed " + json.dumps(hostfed), flush=True)
    del work
    torch.cuda.empty_cache()
    etl, etl_launches = etl_phase()
    etl["card"] = card
    torch.cuda.empty_cache()
    scaled, scaled_launches = scaled_phase(scaled_setup())
    scaled["card"] = card
    print("scaled " + json.dumps(scaled), flush=True)
    torch.cuda.empty_cache()
    step_check = step_grad_check()
    mesh, mesh_launches = mesh_phase()
    mesh["card"] = card
    mesh_rows, mesh_rows_launches = mesh_rows_phase()
    mesh_rows["card"] = card
    phase_s = {}
    t0 = time.perf_counter()
    mesh_model, mesh_model_launches = mesh_model_phase()
    phase_s["mesh_model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multihost, multihost_launches = multihost_phase()
    phase_s["multihost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_scripts, mesh_scripts_launches = mesh_scripts_phase()
    phase_s["mesh_scripts"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    studies, studies_launches = studies_phase()
    phase_s["studies"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reference_scale, reference_launches = reference_scale_phase()
    phase_s["reference_scale"] = time.perf_counter() - t0
    for name, row in (("multihost", multihost), ("mesh_scripts", mesh_scripts), ("studies", studies),
                      ("reference_scale", reference_scale)):
        print(f"{name} " + json.dumps({**row, "card": card}), flush=True)
    print("new phases s " + json.dumps(phase_s), flush=True)
    text_encoder = text_encoder_phase()
    print("text_encoder " + json.dumps({**text_encoder, "card": card}), flush=True)

    launches = {"serving": serving["launches"], "training": training["launches"], **eval_launches, **extra_launches,
                **headline_counts, **serve_launches, **resume_launches, **profile_launches, **hostfed_launches_by_path,
                **etl_launches, **scaled_launches, **mesh_launches, **mesh_rows_launches, **mesh_model_launches, **multihost_launches,
                **mesh_scripts_launches, **studies_launches, **reference_launches}
    record = {"kernels": [
        kernel_record("onehot_lookup", "K1", "onehot_lookup.cu", "embedding_grad.py:358",
                      kernels["onehot_lookup"], launches, "dense_table_lookup", "training"),
        kernel_record("table_grad", "K2", "table_grad.cu", "embedding_grad.py:45",
                      kernels["table_grad"], launches, "dense_table_grad", "training"),
        kernel_record("table_grad_bmajor", "K3", "table_grad.cu", "embedding_grad.py:227",
                      kernels["table_grad_bmajor"], launches, "dense_table_grad_bmajor", "embgrad"),
        kernel_record("row_gather", "K4", "row_gather.cu", "embedding_lookup.py:46",
                      kernels["row_gather"], launches, "embedding_lookup_pallas", "scaled_dense"),
        kernel_record("fused_stats", "K5", "fused_stats.cu", "fused_logits.py:95",
                      kernels["fused_stats"], launches, "fused_stats_sweep", "eval"),
        kernel_record("fused_ce_fwd", "K6", "fused_ce_fwd.cu", "fused_logits.py:280",
                      kernels["fused_ce_fwd"], launches, "fused_lean_lse", "training"),
        kernel_record("fused_ce_fwd_blocked", "K7", "fused_ce_fwd.cu", "fused_logits.py:387",
                      kernels["fused_ce_fwd_blocked"], launches, "fused_lean_lse", "train_b16384"),
        kernel_record("same_tile_diag", "K8", "fused_stats.cu", "fused_logits.py:518",
                      kernels["same_tile_diag"], launches, "same_tile_diag", "eval_b16384"),
        kernel_record("fused_stats_blocked", "K9", "fused_stats.cu", "fused_logits.py:553",
                      kernels["fused_stats_blocked"], launches, "fused_stats_sweep", "eval_b16384"),
        kernel_record("fused_ce_bwd_blocked", "K10", "fused_ce_bwd.cu", "fused_logits.py:707",
                      kernels["fused_ce_bwd_blocked"], launches, "fused_ce_bwd", "train_b16384"),
        kernel_record("fused_ce_bwd", "K11", "fused_ce_bwd.cu", "fused_logits.py:819",
                      kernels["fused_ce_bwd"], launches, "fused_ce_bwd", "training"),
    ], "chunk_topk": {  # the index scan's top-k: it replaces no TPU kernel
        "source": "jodalrob_twotower_torch/csrc/chunk_topk.cu", "launches_serving": launches["serving"]["chunk_topk"],
        "equal": all(r.get("equal", True) for r in kernels["chunk_topk"]),
        "cases": [{key: r[key] for key in ("case", "ms", "bound_ms", "plain_ms", "library_ms", "first_chunk_ms",
                                          "later_chunk_ms", "tally") if key in r} for r in kernels["chunk_topk"]]},
        "int8_scan": {  # the int8 scan's product: it replaces no TPU kernel
            "source": "jodalrob_twotower_torch/csrc/int8_scan.cu", "launches_serving": launches["serving"]["int8_scan"],
            "launches_by_path": {p: counts["int8_scan"] for p, counts in launches.items() if "int8_scan" in counts},
            "cases": [{key: r[key] for key in ("case", "ms", "bound_ms", "plain_ms", "library_ms", "scan_ms_per_chunk",
                                              "max_gap_ulps", "launches", "other_kernels") if key in r}
                      for r in kernels["int8_scan"]]},
        "training": {k: training[k] for k in ("examples_per_sec", "ms_per_step", "mfu", "device_busy_share",
                                         "device_busy_share_timed")},
        "evaluation": {path: {**{k: evaluation[path][k] for k in ("ms_per_batch", "ms_per_batch_min", "ms_per_batch_max")},
                              "recall@10": evaluation[path]["metrics"]["recall@10"],
                              "device_busy_share": evaluation[path]["device_one_batch"]["busy_share"]}
                       for path in ("eval", "eval_b16384")},
        "corpus": {k: evaluation["corpus"][k] for k in ("recall@10", "recall@100", "mrr", "encode_s", "corpus_eval_s")},
        "extra_training": {path: row["losses"] for path, row in extra.items()},
        "headline": {k: headline[k] for k in ("final_corpus_recall_at_100", "reference_recall_at_100",
                                              "recall_at_100_abs_diff", "learned", "within_tolerance",
                                              "examples_per_sec_last_epoch", "train_wall_s")},
        "serve_cli": {k: serve_cli[k] for k in ("qps", "ms_per_batch", "int8_recall_at_100_vs_exact",
                                                "int8_recall_at_100_ties_counted", "int8_rows_tied_vs_plain",
                                                "exact_rows_tied_vs_plain", "target_recall_pick",
                                                "target_recall_measured")},
        "calibration": {k: serving["calibration"][k] for k in ("companies", "pick", "device_s", "host_streamed_s",
                                                               "exact_streamed_scan_s", "rows_tied_at_k")},
        "profile": {k: profile[k] for k in ("ms_per_step", "attribution_ms_per_step", "matmul_peak_tflops")}
        | {"trace_busy_share": profile["trace"]["busy_share"]},
        "resume": {k: resume[k] for k in ("steps", "leaves_differing", "cross_device_differing", "search_equal",
                                          "trainer_call_device_ms", "trainer_call_busy_share")},
        "hostfed": {
            "index": {k: hostfed["index"][k] for k in ("examples_per_sec", "ms_per_step", "resident_windows_ms_per_step",
                                                       "sampled_examples_per_sec", "sampled_ms_per_step", "steps")},
            "features": {k: hostfed["features"][k] for k in ("examples_per_sec", "ms_per_step",
                                                             "inline_gather_ms_per_step",
                                                             "resident_batches_ms_per_step", "mb_per_step",
                                                             "effective_h2d_mb_per_s", "one_batch_copy_ms",
                                                             "pinned_copy_mb_per_s")}
            | {"consumer_wait_ms_median": hostfed["features"]["consumer_wait_ms"]["median"],
               "race_check_equal": hostfed["features"]["race_check"]["losses_equal"]
               and not hostfed["features"]["race_check"]["leaves_differing"]},
            "streaming_trainer": {k: hostfed["streaming_trainer"][k] for k in ("steps", "train_loss", "val_loss",
                                                                               "examples_per_sec", "wall_s")},
            "phase_s": hostfed["phase_s"],
        },
        "etl": {k: etl[k] for k in ("etl_rows_per_s", "notice_table", "train_loss", "examples_per_sec", "ms_per_step",
                                   "corpus_recall@100", "serve_qps", "int8_recall_at_100_vs_exact",
                                   "int8_rows_tied_vs_plain", "crc32c", "quickstart_s", "phase_s", "card")}
        | {"tfrecord_mb_per_s": {side: {"write": r["write_mb_per_s"], "read": r["read_mb_per_s"]}
                                 for side, r in etl["tfrecord"].items()},
           "tfrecord_codec_mb_per_s": {way: etl["tfrecord_codec"][f"{way}_mb_per_s"] for way in ("direct", "general")}},
        "scaled": {path: {k: scaled[path][k] for k in ("ms_per_step", "examples_per_sec", "device_busy_share",
                                                       "device_busy_share_timed", "loss_last_call")}
                   for path in SCALED_PATHS},
        "sparse_vs_dense": {k: v for k, v in scaled["sparse_vs_dense"].items() if isinstance(v, dict)},
        "diag_bits": kernels["diag_bits"],
        "largest_batch": kernels["largest_batch"],
        "fused_ce_bwd_build": bwd_build,
        "fused_ce_fwd_build": fwd_build,
        "fused_stats_build": stats_build,
        "onehot_lookup_build": lookup_build,
        "row_gather_build": gather_build,
        "step_check": {k: step_check[k] for k in ("loss_abs_err", "max_grad_rel_err", "worst_share_of_tolerance")},
        "mesh": {"ranks": mesh["ranks"], "backend": mesh["backend"], "ranks_s": mesh["ranks_s"], "cli_s": mesh["cli_s"],
                 "trainer": {k: mesh["trainer"][k] for k in ("steps", "train_loss", "val_loss", "corpus_recall@100",
                                                             "examples_per_sec", "wall_s")},
                 "step_check": {k: mesh["step_check"][k] for k in ("loss_rel_err", "max_grad_rel_err",
                                                                   "worst_share_of_tolerance")},
                 "b16384_wall_s": mesh["b16384"]["wall_s"], "ls0.1_wall_s": mesh["ls0.1"]["wall_s"],
                 "index": mesh["index"], "nccl_one_rank_bit_equal": mesh["nccl_one_rank"]["bit_equal"]},
        "mesh_rows": {"ranks_s": mesh_rows["ranks_s"], **{
            path: [{k: r[k] for k in ("ms_per_step", "examples_per_sec", "peak_memory_gb", "loss_rel_err",
                                      "table_blocks_max_err_past_rtol", "replicated_share_past_tol",
                                      "checkpoint_gather_s", "wire_bytes_per_rank", "path_s") if k in r}
                   for r in mesh_rows[path]]
            for path in (*MESH_ROWS_PATHS, MESH_ROWS_INT16)}},
        "mesh_compressed": {
            "phase_s": mesh["compressed"]["phase_s"], "first_losses": mesh["compressed"]["first_losses"],
            "wire_bytes_per_rank": mesh["compressed"]["wire"]["wire_bytes_per_rank"],
            "global_check": {k: mesh["compressed"]["global_check"][k] for k in ("loss_rel_err", "max_grad_rel_err",
                                                                                 "max_param_abs_diff")},
            "trainer": {m: {k: r[k] for k in ("train_loss", "val_loss", "ms_per_step", "peak_memory_gb", "wall_s")
                            if k in r} for m, r in mesh["compressed"]["trainer"].items()},
            "final_loss_rel_to_none": mesh["compressed"]["final_loss_rel_to_none"],
            "timed_ms_per_step": {k: v["ms_per_step"] for k, v in mesh["compressed"]["timed"].items()}},
        "mesh_model": {k: mesh_model[k] for k in ("ranks", "axes", "backend", "ranks_s", "losses", "eval",
                                                  "bit_equal_across_model_axis", "bit_equal_to_2x1",
                                                  "ms_per_step_incl_eval", "examples_per_sec")},
        "multihost": {k: multihost[k] for k in ("ok", "processes", "backend", "losses", "fused_loss",
                                                "stream_batches", "stream_loss", "compressed_loss",
                                                "compressed_launches", "compressed_global_loss",
                                                "store_gather_exact")},
        "sharded_serving": {k: {m: r[m] for m in ("wall_ms_per_1024q", "recall_vs_exact_at100", "single_device_recall")}
                            for k, r in mesh_scripts["sharded_serving"].items() if isinstance(r, dict)},
        "rowsharded_store": {m: {k: mesh_scripts["rowsharded_store"][m][k]
                                 for k in ("ms_per_step", "examples_per_sec", "store_total_mb", "store_per_rank_mb")}
                             for m in ("rows", "replicated")},
        "scaling_sweep": [{k: r[k] for k in ("devices", "backend", "examples_per_sec", "step_ms", "vs_1dev")}
                          for r in mesh_scripts["scaling_sweep"]["rows"]],
        "studies": {name: [{k: v for k, v in r.items() if k in ("bench", "variant", "ms_per_call", "ms")}
                           for r in studies[name]["rows"]] for name in studies},
        "reference_scale": {k: reference_scale[k] for k in ("steps", "train_loss", "val_loss", "recall@10", "mrr",
                                                            "auc", "corpus_recall", "corpus_mrr", "examples_per_sec",
                                                            "wall_s")},
        "new_phases_s": phase_s,
        "text_encoder": {k: text_encoder[k] for k in ("launches_per_search", "pooled_vs_plain_rel", "search_ms",
                                                      "encode_ms", "peak_memory_gb")},
        "card": card}
    by_kernel = {rec["tpu_kernel"]: rec for rec in record["kernels"]}
    by_kernel["K6"]["also_replaces"] = "jodalrob_twotower_tpu/ops/fused_logits.py:241"
    by_kernel["K10"]["also_replaces"] = "jodalrob_twotower_tpu/ops/fused_logits.py:724"
    for key in ("K1", "K5", "K6", "K7", "K8", "K9", "K10", "K11"):  # every timed case beside the main case
        by_kernel[key]["timed_cases"] = [{k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                                         for r in by_kernel[key]["cases"] if "ms" in r]
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
