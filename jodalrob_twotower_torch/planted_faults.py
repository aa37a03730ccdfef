"""Shows that ``chip_smoke.py``'s checks fail on a wrong kernel: plants a
fault in the output of a CUDA wrapper, runs the check that guards it once
sound and once per fault, and reports each fault as caught or not.

* The table-gradient check (K2 and K3 against their plain versions at the
  training path's shapes, ``chip_smoke.table_grad_phase`` untimed) against
  K2's cluster merge leaving out the last rank's partial: the gradient of
  the batch's last B/C rows, C the wrapper's cluster size.
* The step check (one B=1024 step's loss and gradients on the card against
  the same step on the CPU) against the table gradient (K2) losing whole
  128-row tiles, and the CE backward (K11) losing rows of dc. The CPU side
  of the check takes the plain versions, so only the card's side carries the
  fault.
* The lean forward check (K6 against its plain version at B=8192, D=128,
  unshifted: ``chip_smoke.lean_case``) against the column merge dropping the
  last partial of each column (the rows of the last CTA whose range meets
  the column's block), and row_lse taken from one column block too few (the
  last NW columns of C left out).
* The wide backward check (K11 against its plain version at B=8192, D=512)
  against the second warpgroup's half of dn (columns 256..511) coming out
  as 0, or as the last column tile's contribution alone (an accumulator
  overwritten per tile instead of summed).
* The statistics check (K8 and the sweep against their plain versions at
  B=8192, ranks under the near-tie rule) against K8 handing each row the
  next row's diagonal, the sweep's column merge dropping the first row
  block, and the sweep counting one more entry above the diagonal in every
  row (as a diagonal column not left out would).
* The same statistics check against the sweep's CTA ranges ending one
  unit short (the last unit of every range in no statistic), rank leaving
  out the diagonal by value instead of by index (with K8's S_ii, so only
  the check's second call, with a diagonal below every S_ii, can see it),
  and the column merge taking each column's per-CTA partials in an order
  that changes between calls (two calls must be bit-equal).
* The lookup check (K1 bit-exact against its plain version in its six
  cases) against the ownership test reading the next tile's feature.
* The row-gather check (K4 bit-exact against its plain version at the
  config-3 shape, and its zero form on a mesh rank's block with the block's
  edge ids planted) against K4 returning row r + 1 for every 64th row, the
  zero form reading the row at offset + rows (the next one in memory, or
  the block's last at the table's end) for the id just past the block
  instead of writing zero, and the zero form leaving the rows of ids below
  the block unfilled (the clamped row 0 read for them).
* The sparse-against-dense check (two sparse steps against two dense steps
  at config 3) against the sparse update skipping the dedup of duplicate
  rows (as ``sparse_duplicate_handling="per_occurrence"`` would).
* The calibration check (``chip_smoke.calibration_check``: the serve CLI's
  auto-configuration over 1,000,000 unit rows on the card, from the device
  and streamed from the host) against the streamed exact scan dropping its
  last slice of corpus rows.

Run from the repository root on a machine with a CUDA card:
``python3 -m jodalrob_twotower_torch.planted_faults``. Exits nonzero if a
sound check fails or a fault goes uncaught.
"""

from __future__ import annotations

import sys

import torch

from jodalrob_twotower_torch.ops import embedding_grad, embedding_lookup, fused_logits
from jodalrob_twotower_torch.serving import autoconfig
from jodalrob_twotower_torch.train import sparse_tables


def _tile_loss(every: int):
    """K2 whose every ``every``-th tile of the table gradient comes out 0."""
    real = embedding_grad.dense_table_grad

    def fault(rows, g, tile_feature):
        out = real(rows, g, tile_feature)
        if out.is_cuda:
            out.view(-1, embedding_grad.TILE_ROWS, out.shape[1])[::every] = 0
        return out

    fault.launches = 0  # the wrapper counts its launches on the module's name
    return embedding_grad, "dense_table_grad", fault


def _merge_drops_last_rank():
    """K2 whose cluster merge leaves out the last rank's partial: its output
    less the plain gradient of the batch's last B/C rows."""
    real = embedding_grad.dense_table_grad

    def fault(rows, g, tile_feature):
        out = real(rows, g, tile_feature)
        if out.is_cuda:
            b = rows.shape[0]
            c, _ = embedding_grad.table_grad_launch_shape(b, out.shape[0])
            lo = (c - 1) * b // c
            out -= embedding_grad.dense_table_grad_plain(rows[lo:], g[lo:], tile_feature)
        return out

    fault.launches = 0
    return embedding_grad, "dense_table_grad", fault


def _dc_loss(rows_lost: int):
    """K11 whose first ``rows_lost`` rows of dc come out 0."""
    real = fused_logits.fused_ce_bwd

    def fault(*args):
        dn, dc = real(*args)
        if dc.is_cuda:
            dc[:rows_lost] = 0
        return dn, dc

    fault.launches = 0
    return fused_logits, "fused_ce_bwd", fault


def _dn_upper_half(last_tile_only: bool):
    """K11 whose dn columns 256..511 (at D = 512) come out as 0, or as the
    contribution of the last 64-column tile of C alone."""
    real = fused_logits.fused_ce_bwd

    def fault(n_scaled, c, row_lse, col_lse, label_smoothing=0.0, row_offset=0):
        dn, dc = real(n_scaled, c, row_lse, col_lse, label_smoothing, row_offset)
        if dn.is_cuda and dn.shape[1] == 512:
            if last_tile_only:
                b, rows = c.shape[0], n_scaled.shape[0]
                inv2b, diag_coef, smooth = fused_logits._bwd_constants(b, label_smoothing)
                ct = c[b - 64 :].to(torch.bfloat16).float()
                s = n_scaled.to(torch.bfloat16).float() @ ct.T
                x = torch.exp(s - row_lse[:, None]) + torch.exp(s - col_lse[None, b - 64 :])
                col = torch.arange(b - 64, b, device=s.device)
                x -= diag_coef * (col[None, :] == torch.arange(rows, device=s.device)[:, None] + row_offset)
                a = (inv2b * (x - smooth)).to(torch.bfloat16).float()
                dn[:, 256:] = a @ ct[:, 256:]
            else:
                dn[:, 256:] = 0
        return dn, dc

    fault.launches = 0
    return fused_logits, "fused_ce_bwd", fault


def _lean_col_drops_last_piece():
    """K6 whose column merge leaves out each column's last partial: col_lse
    over the rows before the last CTA range that meets the column's block."""
    real = fused_logits.fused_lean_lse

    def fault(n_scaled, c, *, nomax):
        row_lse, col_lse = real(n_scaled, c, nomax=nomax)
        if col_lse.is_cuda:
            rows, b, d = n_scaled.shape[0], c.shape[0], c.shape[1]
            shape = fused_logits.lean_lse_launch_shape(rows, b, d, nomax)
            block = shape.block_cols
            n_y = rows // 64
            units = -(-b // block) * n_y
            starts = [k * units // shape.ctas for k in range(shape.ctas + 1)]
            s = n_scaled.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
            for x in range(-(-b // block)):
                last_unit = x * n_y + n_y - 1
                k_last = max(k for k in range(shape.ctas) if starts[k] <= last_unit)
                kept = (max(starts[k_last], x * n_y) - x * n_y) * 64  # rows before the last piece
                cols = slice(x * block, min(b, (x + 1) * block))
                col_lse[cols] = torch.logsumexp(s[:kept, cols], 0) if kept else float("-inf")
        return row_lse, col_lse

    fault.launches = 0
    return fused_logits, "fused_lean_lse", fault


def _lean_row_one_block_short():
    """K6 whose row merge leaves out the last NW-column block: row_lse over
    the columns before it."""
    real = fused_logits.fused_lean_lse

    def fault(n_scaled, c, *, nomax):
        row_lse, col_lse = real(n_scaled, c, nomax=nomax)
        if row_lse.is_cuda:
            b, d = c.shape
            nw = fused_logits.lean_lse_launch_shape(n_scaled.shape[0], b, d, nomax).sub_cols
            s = n_scaled.to(torch.bfloat16).float() @ c[: b - nw].to(torch.bfloat16).float().T
            row_lse = torch.logsumexp(s, 1)
        return row_lse, col_lse

    fault.launches = 0
    return fused_logits, "fused_lean_lse", fault


def _diag_next_row():
    """K8 that gives row i the diagonal of row i + 1."""
    real = fused_logits.same_tile_diag

    def fault(n_scaled, c, row_offset=0):
        out = real(n_scaled, c, row_offset)
        return torch.roll(out, -1) if out.is_cuda else out

    fault.launches = 0
    return fused_logits, "same_tile_diag", fault


def _merge_drops_first_block():
    """The sweep whose column merge leaves out the partials of row block 0
    (rows 0..63): the column statistics of the other rows only."""
    real = fused_logits.fused_stats_sweep

    def fault(n_scaled, c, diag, row_offset=0):
        row_stats, col_stats = real(n_scaled, c, diag, row_offset)
        if col_stats.is_cuda:
            s = n_scaled[64:].to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
            col_stats = torch.stack([torch.logsumexp(s, 0), s.sum(0)])
        return row_stats, col_stats

    fault.launches = 0
    return fused_logits, "fused_stats_sweep", fault


def _rank_counts_diagonal():
    """The sweep whose rank counts one more entry in every row."""
    real = fused_logits.fused_stats_sweep

    def fault(n_scaled, c, diag, row_offset=0):
        row_stats, col_stats = real(n_scaled, c, diag, row_offset)
        if row_stats.is_cuda:
            row_stats[:, 3] += 1
        return row_stats, col_stats

    fault.launches = 0
    return fused_logits, "fused_stats_sweep", fault


def _plain_scores(n_scaled, c):
    return n_scaled.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T


def _sweep_skips_last_unit():
    """The sweep whose CTA ranges end one unit short: the last unit (a
    64-row tile against a block of W 64-column slices) of every CTA's range
    is in neither the row nor the column statistics."""
    real = fused_logits.fused_stats_sweep

    def fault(n_scaled, c, diag, row_offset=0):
        row_stats, col_stats = real(n_scaled, c, diag, row_offset)
        if row_stats.is_cuda:
            rows, (b, d) = n_scaled.shape[0], c.shape
            shape = fused_logits.stats_launch_shape(rows, b, d)
            n_y = rows // 64
            units = -(-b // shape.block_cols) * n_y
            s = _plain_scores(n_scaled, c)
            kept = torch.ones_like(s, dtype=torch.bool)
            for k in range(shape.ctas):
                u = (k + 1) * units // shape.ctas - 1
                x, y = divmod(u, n_y)
                kept[y * 64 : (y + 1) * 64, x * shape.block_cols : (x + 1) * shape.block_cols] = False
            idx = torch.arange(rows, device=s.device)
            above = (s > diag[:, None]) & kept
            above[idx, idx + row_offset] = False
            lse_s = torch.where(kept, s, float("-inf"))
            sum_s = torch.where(kept, s, 0.0)
            row_stats = torch.stack([torch.logsumexp(lse_s, 1), sum_s.sum(1), diag, above.sum(1).float()], 1)
            col_stats = torch.stack([torch.logsumexp(lse_s, 0), sum_s.sum(0)])
        return row_stats, col_stats

    fault.launches = 0
    return fused_logits, "fused_stats_sweep", fault


def _rank_skips_diagonal_by_value():
    """The sweep whose rank leaves out the entries equal to the row's
    diagonal instead of the diagonal's own column: S_ii counts wherever it
    exceeds the diagonal it was given. S_ii is the kernels' own (K8's), so
    the fault adds nothing where the diagonal given is K8's and shows only
    against a lowered diagonal."""
    real = fused_logits.fused_stats_sweep

    def fault(n_scaled, c, diag, row_offset=0):
        row_stats, col_stats = real(n_scaled, c, diag, row_offset)
        if row_stats.is_cuda:
            s_ii = fused_logits.same_tile_diag(n_scaled, c, row_offset)
            row_stats[:, 3] += (s_ii > diag).float()
        return row_stats, col_stats

    fault.launches = 0
    return fused_logits, "fused_stats_sweep", fault


def _col_merge_out_of_order():
    """The sweep whose column merge takes each column's per-CTA partials in
    an order that changes from call to call (as atomics would): the column
    lse of the pieces merged in a random order."""
    real = fused_logits.fused_stats_sweep

    def fault(n_scaled, c, diag, row_offset=0):
        row_stats, col_stats = real(n_scaled, c, diag, row_offset)
        if col_stats.is_cuda:
            rows, (b, d) = n_scaled.shape[0], c.shape
            shape = fused_logits.stats_launch_shape(rows, b, d)
            n_y, block = rows // 64, shape.block_cols
            units = -(-b // block) * n_y
            starts = [k * units // shape.ctas for k in range(shape.ctas + 1)]
            s = _plain_scores(n_scaled, c)
            for x in range(-(-b // block)):
                cols = slice(x * block, min(b, (x + 1) * block))
                pieces = [(max(starts[k], x * n_y) - x * n_y, min(starts[k + 1], (x + 1) * n_y) - x * n_y)
                          for k in range(shape.ctas) if starts[k] < (x + 1) * n_y and starts[k + 1] > x * n_y]
                lse = [torch.logsumexp(s[lo * 64 : hi * 64, cols], 0) for lo, hi in pieces]
                merged = None
                for p in torch.randperm(len(lse)).tolist():
                    merged = lse[p] if merged is None else torch.logaddexp(merged, lse[p])
                col_stats[0, cols] = merged
        return row_stats, col_stats

    fault.launches = 0
    return fused_logits, "fused_stats_sweep", fault


def _lookup_next_tile():
    """K1 whose ownership test reads the tile after the row's: a row serves
    when tile_feature[row // 128 + 1] is its feature."""
    real = embedding_grad.dense_table_lookup

    def fault(table, rows, tile_feature):
        out = real(table, rows, tile_feature)
        if out.is_cuda:
            shifted = torch.cat([tile_feature[1:], tile_feature[-1:]])
            out = embedding_grad.dense_table_lookup_plain(table, rows, shifted)
        return out

    fault.launches = 0
    return embedding_grad, "dense_table_lookup", fault


def _gather_next_row():
    """K4 that returns row r + 1 for every 64th output row."""
    real = embedding_lookup.embedding_lookup_pallas

    def fault(table, rows):
        out = real(table, rows)
        if out.is_cuda:
            flat, r = out.view(-1, table.shape[1]), rows.reshape(-1)[::64].long()
            flat[::64] = table.index_select(0, (r.clamp(0, table.shape[0] - 1) + 1).clamp(max=table.shape[0] - 1))
        return out

    fault.launches = 0
    return embedding_lookup, "embedding_lookup_pallas", fault


def _zero_form_past_upper_edge():
    """K4's zero form with an off-by-one at the block's upper edge: the id
    offset + rows reads the row after the block's last (the next one in
    memory where the block is a view of a larger table, else the last)."""
    real = embedding_lookup.embedding_lookup_pallas_shard

    def fault(block, ids, offset, **kw):
        out = real(block, ids, offset, **kw)
        if out.is_cuda:
            rows, d = block.shape
            room = block.untyped_storage().nbytes() // block.element_size() - block.storage_offset() >= (rows + 1) * d
            past = block.as_strided((rows + 1, d), block.stride())[rows] if room else block[rows - 1]
            out.view(-1, d)[ids.reshape(-1) == offset + rows] = past
        return out

    return embedding_lookup, "embedding_lookup_pallas_shard", fault


def _zero_form_skips_below():
    """K4's zero form that skips the zero fill for ids below the block:
    their rows hold the clamped read of the block's row 0."""
    real = embedding_lookup.embedding_lookup_pallas_shard

    def fault(block, ids, offset, **kw):
        out = real(block, ids, offset, **kw)
        if out.is_cuda:
            out.view(-1, block.shape[1])[ids.reshape(-1) < offset] = block[0]
        return out

    return embedding_lookup, "embedding_lookup_pallas_shard", fault


def _no_dedup():
    """The sparse rowwise-Adagrad update that skips the dedup: every
    occurrence of a duplicate row accumulates and steps on its own."""
    real = sparse_tables.sparse_rowwise_adagrad_update

    def fault(st, rows, grads, *, lr, eps, dedup=True):
        return real(st, rows, grads, lr=lr, eps=eps, dedup=dedup and not rows.is_cuda)

    return sparse_tables, "sparse_rowwise_adagrad_update", fault


def _stream_drops_last_slice():
    """The streamed exact scan that never reads the corpus's last slice."""
    real = autoconfig._exact_topk_streamed

    def fault(corpus_np, query_emb, k, chunk, query_chunk=1024, *, device=None):
        n = corpus_np.shape[0]
        last = (n - 1) // min(chunk, n) * min(chunk, n)
        return real(corpus_np[:last], query_emb, k, chunk, query_chunk, device=device)

    return autoconfig, "_exact_topk_streamed", fault


def _grad_check(chip_smoke):
    chip_smoke.table_grad_phase(None, runs=0)


def _step_check(chip_smoke):
    chip_smoke.step_grad_check()


def _lean_check(chip_smoke):
    chip_smoke.lean_case(None, chip_smoke.CE_BATCH, True)


def _wide_bwd_check(chip_smoke):
    chip_smoke.bwd_case(None, chip_smoke.CE_BATCH, d=512)


def _stats_check(chip_smoke):
    chip_smoke.stats_case(None, chip_smoke.CE_BATCH)


def _lookup_check(chip_smoke):
    chip_smoke.lookup_phase(None, runs=0)


def _gather_check(chip_smoke):
    chip_smoke.row_gather_phase(None)


def _sparse_check(chip_smoke):
    if not _scaled:
        _scaled.append(chip_smoke.scaled_setup())
    chip_smoke.sparse_vs_dense_check(_scaled[0])


_scaled: list = []  # config 3's data and model, built once


def _calibration_check(chip_smoke):
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    corpus = chip_smoke.unit_rows(gen, chip_smoke.N_COMPANIES, chip_smoke.CE_DIM, "cuda")
    queries = chip_smoke.unit_rows(gen, chip_smoke.CALIBRATION_QUERIES, chip_smoke.CE_DIM, "cuda")
    chip_smoke.calibration_check(corpus, queries)


FAULTS = {
    "K2's merge drops the last rank's partial": (_merge_drops_last_rank, _grad_check),
    "K2 loses every 16th tile": (lambda: _tile_loss(16), _step_check),
    "K2 loses every 64th tile": (lambda: _tile_loss(64), _step_check),
    "K11 loses dc rows 0..63": (lambda: _dc_loss(64), _step_check),
    "K11 loses dc rows 0..7": (lambda: _dc_loss(8), _step_check),
    "K6's column merge drops each column's last partial": (_lean_col_drops_last_piece, _lean_check),
    "K6's row_lse leaves out the last column block": (_lean_row_one_block_short, _lean_check),
    "K11 at D=512 zeroes dn columns 256..511": (lambda: _dn_upper_half(False), _wide_bwd_check),
    "K11 at D=512 keeps only the last tile in dn columns 256..511": (lambda: _dn_upper_half(True), _wide_bwd_check),
    "K8 reads the next row's diagonal": (_diag_next_row, _stats_check),
    "K5 column merge drops row block 0": (_merge_drops_first_block, _stats_check),
    "K5 rank counts one more entry per row": (_rank_counts_diagonal, _stats_check),
    "K5 sweep's CTA ranges end one unit short": (_sweep_skips_last_unit, _stats_check),
    "K5 rank leaves out the diagonal by value, not by index": (_rank_skips_diagonal_by_value, _stats_check),
    "K5 column merge out of CTA order": (_col_merge_out_of_order, _stats_check),
    "K1 ownership test reads the next tile": (_lookup_next_tile, _lookup_check),
    "K4 returns row r+1 for every 64th row": (_gather_next_row, _gather_check),
    "K4's zero form reads the row at offset + rows": (_zero_form_past_upper_edge, _gather_check),
    "K4's zero form skips the zero fill below the block": (_zero_form_skips_below, _gather_check),
    "sparse update skips the dedup": (_no_dedup, _sparse_check),
    "streamed exact scan drops its last slice": (_stream_drops_last_slice, _calibration_check),
}


def main() -> int:
    import chip_smoke  # the repository root's smoke script: run from the root

    print(chip_smoke.bench.card_line(), flush=True)
    chip_smoke._build.build(chip_smoke.KERNEL_SOURCES)
    for check in (_grad_check, _step_check, _lean_check, _wide_bwd_check, _stats_check, _lookup_check, _gather_check,
                  _sparse_check, _calibration_check):
        check(chip_smoke)
        print(f"sound {check.__name__.strip('_')} passed", flush=True)
    missed = []
    for name, (make, check) in FAULTS.items():
        module, attr, fault = make()
        real = getattr(module, attr)
        setattr(module, attr, fault)
        try:
            check(chip_smoke)
            missed.append(name)
            print(f"planted fault NOT caught: {name}", flush=True)
        except RuntimeError as e:
            print(f"planted fault caught: {name}: {e}", flush=True)
        finally:
            setattr(module, attr, real)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
