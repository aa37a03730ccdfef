// Backward of the bidirectional in-batch CE for Hopper (sm_90a): dN and dC
// without writing S or dL/dS.
//
// Replaces the TPU kernels jodalrob_twotower_tpu/ops/fused_logits.py:819
// `_bwd_kernel` (B <= 8192, through `_fused_bwd_call`) and :707 / :724
// `_bwd_dn_blocked_kernel` / `_bwd_dc_blocked_kernel` (8192 < B <= 65536).
// For N [rows, D] (scaled by 1/tau) and C [B, D], both bf16, the statistics
// row_lse [rows] and col_lse [B] of the forward, label smoothing eps and the
// global row index row_offset of N's first row (0 on one device):
//
//   A[i, j] = bf16( (1/2B) [ exp(S_ij - row_lse_i) + exp(S_ij - col_lse_j)
//                            - 2 (1 - eps) [j == i + row_offset] - 2 eps / B ] )
//   dn = A C        [rows, D] f32          dc = A^T N        [B, D] f32
//
// A is rounded to bf16 before both products, as on the TPU
// (fused_logits.py:844-846).
//
// Bound. The function needs 6 B^2 D products (S once, A C, A^T N) and 2 B^2
// exponentials: at B = 8192 that is 51.5 GFLOP at D = 128 (0.052 ms at the
// 989 TFLOP/s bf16 peak of an H100 SXM at its 700 W limit) and 206 GFLOP at
// D = 512 (0.208 ms); the bytes are 8.5 MB at D = 128. Bound by operations. This kernel forms S in both sweeps,
// so it does 8 B^2 D products and 4 B^2 exponentials.
//
// Design (D <= 512). Two sweeps in one launch: the first blocks of the grid
// take dn (the rows of N against the 64-row tiles of C), the rest dc (the
// rows of C against the tiles of N: S^T = C N^T, the same code with the
// operands, the two lse vectors and the side of the diagonal swapped). Every
// output row is summed by one warpgroup in tile order, with no atomics, so
// two calls give the same bits. A block has two consumer warpgroups and one
// producer warpgroup, which hands its registers to the consumers
// (setmaxnreg: 40 a thread for it, 232 for them):
//   - one producer thread loads the block's own rows once and streams the
//     other side's tiles, each with its 64 column lse values, through a ring
//     of shared-memory stages, all by TMA ([64, 64] boxes with the 128-byte
//     swizzle; the lse by a bulk copy) with mbarriers; a consumer warp
//     releases a stage once the products that read it have completed;
//   - S = R T^T of a [64 rows, 64 columns] tile runs as wgmma m64nNk16 over
//     D / 16 steps, both operands K-major from shared memory; out += A T
//     reads the same T tile as MN-major (the descriptor's transpose bit), so
//     one copy of each tile serves both products; S is formed once per
//     (row block, tile) in each sweep, and the whole [64, D] f32 output stays
//     in registers for the whole sweep;
//   - D <= 256: a block owns 128 rows, one 64-row group per consumer
//     warpgroup, which holds its S tile (32 registers a thread) and its
//     [64, D] output (D / 2); the S accumulators, packed to bf16, are the
//     A operand of the second wgmma (m64nDk16) straight from registers.
//     The two warpgroups share each T tile, and one's exponentials run
//     while the other's wgmma are in flight;
//   - D = 384, 512: [64, D] would take more than 255 registers a thread,
//     so a block owns 64 rows and its two consumer warpgroups split the
//     output columns (D / 4 registers each). Each forms half of the S tile's
//     columns (m64n32), writes its bf16 half of A to a swizzled [64, 64]
//     shared tile (two buffers, alternating per tile), and after a named
//     barrier runs its output half from the whole of A (m64n(D/2)k16);
//   - at D = 128, where the registers allow a second S array, a warpgroup
//     issues the next tile's S before it forms this tile's A, so its own
//     exponentials overlap its tensor work as well;
//   - no instruction but a wgmma writes an accumulator while a wgmma is in
//     flight (the first step of each product overwrites its accumulators
//     instead of taking zeros), or ptxas serializes every wgmma;
//   - exp(S - lse) is ex2.approx.ftz(S log2 e - lse log2 e), one fma and
//     one special-function op (a term below 2^-126 flushes to 0, far below
//     what A keeps);
//   - shared memory: the block's rows, the ring (4 stages at D = 128 and
//     256, 3 at 384, 2 at 512) and the A buffers, 98 KB at D = 128 and
//     210 KB at D = 512; one block per SM.
// D > 512 (no configuration of either package uses it) takes the earlier
// mma.sync kernel: each block computes one 128-wide output chunk (grid y)
// and recomputes S for it, moving its operands in 128-deep chunks
// (tile_mma.cuh).
//
// Interface: plain C, loaded with ctypes. The entry point launches both
// sweeps, as one grid, on the given stream, does not synchronise, allocates
// nothing, and returns the first error of cudaFuncSetAttribute, the tensor
// maps' encoding or the launch. cuTensorMapEncodeTiled is looked up at run
// time (cudaGetDriverEntryPoint), so the library links no libcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>
#include <stdint.h>

#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tile_mma;

// -- D > 512: mma.sync, one 128-wide output chunk per block ----------------------

constexpr int kBM = 64;           // rows per block
constexpr int kBN = 64;           // columns per tile
constexpr int kWarps = kBM / 16;  // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNSub = kBN / 8;    // 8-column tiles of S per column tile
constexpr int kOutSub = kChunk / 8;  // 8-column tiles of a block's [16, 128] output chunk

// Chunk q of the kBN-row column tile j of m [*, d] into shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* m, int j, int q,
                                          int d, int tid) {
  load_chunk_async<kBN, kThreads>(dst, m + static_cast<int64_t>(j) * kBN * d + q * kChunk, d, tid);
}

// One sweep: out[r, :] = sum_c A[r, c] * cols_m[c, :] for the rows r of
// rows_m, over every column c of cols_m. The diagonal term sits at
// c == r + diag_shift; lse_r and lse_c are the statistics of the rows' and
// the columns' own sides.
struct Sweep {
  const __nv_bfloat16* rows_m;
  const __nv_bfloat16* cols_m;
  const float* lse_r;
  const float* lse_c;
  float* out;
  int n_cols;
  int diag_shift;
};

// Blocks [0, dn_blocks) run the dn sweep, the rest the dc sweep; each block
// owns 64 rows of its sweep and output columns blockIdx.y * 128 .. + 127.
__global__ void __launch_bounds__(kThreads)
ce_bwd_chunked(Sweep dn, Sweep dc, int dn_blocks, int d, float inv2b, float diag_coef,
              float smooth_term) {
  __shared__ __align__(16) __nv_bfloat16 tile[2][kBN * kChunkLd];

  const bool is_dn = static_cast<int>(blockIdx.x) < dn_blocks;
  const Sweep sw = is_dn ? dn : dc;
  const int block = is_dn ? blockIdx.x : blockIdx.x - dn_blocks;
  const __nv_bfloat16* __restrict__ rows_m = sw.rows_m;
  const __nv_bfloat16* __restrict__ cols_m = sw.cols_m;
  const float* __restrict__ lse_r = sw.lse_r;
  const float* __restrict__ lse_c = sw.lse_c;
  float* __restrict__ out = sw.out;
  const int n_cols = sw.n_cols, diag_shift = sw.diag_shift;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = block * kBM + warp * 16 + g;  // this lane's rows: ra and ra + 8

  const int n_chunks = d / kChunk, out_chunk = blockIdx.y;
  // this block's depth order over a tile: out_chunk + 1, ..., n_chunks - 1,
  // 0, ..., out_chunk (a single chunk when D = 128)
  const int first_q = out_chunk + 1 < n_chunks ? out_chunk + 1 : 0;
  uint32_t a[kChunkSteps][4];
  load_row_fragments(a, rows_m, ra, t, d, first_q * kChunk);
  const float lr[2] = {lse_r[ra], lse_r[ra + 8]};

  float acc[kOutSub][4];
#pragma unroll
  for (int o = 0; o < kOutSub; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;

  // ldmatrix row addresses of this lane for the second product: matrix
  // l / 8 covers depth rows (l / 8 % 2) * 8 .. +7 and output columns
  // (l / 16) * 8 .. +7 of a 16 x 16 block
  const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_col = (lane >> 4) * 8;

  // items: (column tile j, k-th chunk of the block's order), k fastest;
  // item i sits in tile[i & 1]
  const int n_tiles = n_cols / kBN;
  const int n_items = n_tiles * n_chunks;
  load_tile(tile[0], cols_m, 0, first_q, d, tid);
  cp_async_commit();
  float s[kNSub][4];
  for (int i = 0, j = 0, k = 0, q = first_q; i < n_items; ++i) {
    const int q_next = q + 1 < n_chunks ? q + 1 : 0;
    if (i + 1 < n_items) {
      load_tile(tile[(i + 1) & 1], cols_m, k + 1 < n_chunks ? j : j + 1, q_next, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ct = tile[i & 1];
    if (n_chunks > 1) load_row_fragments(a, rows_m, ra, t, d, q * kChunk);
    if (k == 0) zero_scores(s);
    chunk_scores(s, a, ct, g, t);
    q = q_next;
    if (k + 1 < n_chunks) {
      ++k;
      __syncthreads();  // the buffer is refilled next iteration
      continue;
    }

    // A in place of S, then packed to bf16 as the next product's A fragments
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + (e >> 1) * 8;
        const int col = j * kBN + ns * 8 + 2 * t + (e & 1);
        const float pc = __expf(s[ns][e] - __ldg(lse_c + col));
        const float pr = __expf(s[ns][e] - lr[e >> 1]);
        float x = (pr + pc) - (col == row + diag_shift ? diag_coef : 0.f);
        x = x - smooth_term;
        v[e] = inv2b * x;
      }
      // columns ns*8.. are depth 0..7 (ns even) or 8..15 (ns odd) of step ns / 2
      pa[ns >> 1][(ns & 1) * 2 + 0] = pack_bf16x2(v[0], v[1]);
      pa[ns >> 1][(ns & 1) * 2 + 1] = pack_bf16x2(v[2], v[3]);
    }

#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
#pragma unroll
      for (int op = 0; op < kOutSub / 2; ++op) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ct + (kc * 16 + lm_row) * kChunkLd + op * 16 + lm_col);
        mma_bf16_16816(acc[2 * op], pa[kc], b[0], b[1]);
        mma_bf16_16816(acc[2 * op + 1], pa[kc], b[2], b[3]);
      }
    }
    __syncthreads();  // the tile buffer is refilled next iteration
    ++j;
    k = 0;
  }

#pragma unroll
  for (int o = 0; o < kOutSub; ++o) {
    const int col = out_chunk * kChunk + o * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra) * d + col) =
        make_float2(acc[o][0], acc[o][1]);
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra + 8) * d + col) =
        make_float2(acc[o][2], acc[o][3]);
  }
}

// -- D <= 512: warpgroups, wgmma and TMA ----------------------------------------

constexpr int kBox = 64;                      // a TMA box and a swizzle block: [64 rows, 64 bf16]
constexpr int kBoxBytes = kBox * kBox * 2;    // 8 KB, 1024-aligned in shared memory
constexpr int kSmemMax = 232448;              // shared memory a block can use
constexpr int kBarrierBytes = 256;

template <int D>
struct Plan {
  static constexpr bool kSplitCols = D > 256;  // two warpgroups share one 64-row group's output
  static constexpr int kRowGroups = kSplitCols ? 1 : 2;
  static constexpr int kBlockRows = kRowGroups * kBox;
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup
  static constexpr int kDepthBoxes = D / kBox;
  static constexpr int kSCols = kSplitCols ? 32 : 64;  // S columns a warpgroup forms per tile
  static constexpr int kOutCols = kSplitCols ? D / 2 : D;  // output columns a warpgroup holds
  // S of the next tile in flight while A of this one is formed: a second S
  // array. Only at D = 128: beside a [64, 256] output it does not fit, and
  // beside the split output it spills at D = 512 and ran slower at 384.
  static constexpr bool kOverlap = D == 128;
  static constexpr int kRBytes = kBlockRows * D * 2;
  static constexpr int kTileBytes = kBox * D * 2;
  static constexpr int kABytes = kSplitCols ? 2 * kBoxBytes : 0;
  static constexpr int kFixed = 1024 + kRBytes + kABytes + kBarrierBytes;  // 1024: alignment slack
  static constexpr int kStageBytes = kTileBytes + kBox * 4;  // a tile and its 64 column lse values
  static constexpr int kFit = (kSmemMax - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = kFixed + kStages * kStageBytes;
  static_assert(D % 128 == 0 && D <= 512 && kStages >= 2, "the wgmma path takes D = 128, 256, 384, 512");
};

// One sweep of the wgmma path: out[r, :] = sum_c A[r, c] * cols[c, :] for
// the n_rows rows of its side; the diagonal term sits at c == r + diag_shift.
struct SweepW {
  const float* lse_r;
  const float* lse_c;
  float* out;
  int n_rows;
  int n_cols;
  int diag_shift;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (r, c) in a [64, 64] bf16 tile with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
ce_bwd_wgmma(const __grid_constant__ CUtensorMap map_n, const __grid_constant__ CUtensorMap map_c,
             SweepW dn, SweepW dc, int dn_blocks, float inv2b, float diag_coef, float smooth_term) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* r_tile = smem;                   // [kDepthBoxes][kRowGroups] boxes
  uint8_t* a_tile = r_tile + P::kRBytes;    // two A buffers (split columns)
  uint8_t* ring = a_tile + P::kABytes;      // kStages tiles of [kDepthBoxes] boxes
  auto* ring_lse = reinterpret_cast<float*>(ring + P::kStages * P::kTileBytes);  // [kStages][64]
  auto* bars = reinterpret_cast<uint64_t*>(ring_lse + P::kStages * kBox);
  uint64_t* full_r = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + P::kStages;

  const bool is_dn = static_cast<int>(blockIdx.x) < dn_blocks;
  const SweepW sw = is_dn ? dn : dc;
  const int block = is_dn ? blockIdx.x : blockIdx.x - dn_blocks;
  const int row0 = block * P::kBlockRows;
  const int left = (sw.n_rows - row0) / kBox;
  const int groups = left < P::kRowGroups ? left : P::kRowGroups;  // 64-row groups present
  const int n_tiles = sw.n_cols / kBox;

  if (threadIdx.x == 0) {
    wgmma::mbar_init(full_r, 1);
    for (int s = 0; s < P::kStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], 4 * (P::kSplitCols ? 2 : groups));  // one arrival per consumer warp
    }
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  // Registers: 168 a thread at launch (ptxas's share of 65,536 over 384
  // threads); the producer gives its warpgroup's up, the consumers take them.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    wgmma::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const CUtensorMap* rows_map = is_dn ? &map_n : &map_c;
      const CUtensorMap* cols_map = is_dn ? &map_c : &map_n;
      wgmma::mbar_expect_tx(full_r, groups * P::kDepthBoxes * kBoxBytes);
      for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
        for (int h = 0; h < groups; ++h) {
          wgmma::tma_load_2d(r_tile + (kb * P::kRowGroups + h) * kBoxBytes, rows_map, kb * kBox,
                             row0 + h * kBox, full_r);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % P::kStages;
        if (j >= P::kStages) wgmma::mbar_wait(&empty[s], (j / P::kStages - 1) & 1);
        wgmma::mbar_expect_tx(&full[s], P::kStageBytes);
        wgmma::bulk_load(ring_lse + s * kBox, sw.lse_c + j * kBox, kBox * 4, &full[s]);
        for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
          wgmma::tma_load_2d(ring + s * P::kTileBytes + kb * kBoxBytes, cols_map, kb * kBox, j * kBox, &full[s]);
        }
      }
    }
    return;
  }

  wgmma::setmaxnreg_inc<232>();
  const int group = P::kSplitCols ? 0 : wg;
  if (group >= groups) return;  // the side's last 64 rows fell in this block's first group
  const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = row0 + group * kBox + warp * 16 + g;  // this lane's rows: ra and ra + 8
  const int s_col = P::kSplitCols ? wg * 32 : 0;       // this warpgroup's S columns in a tile
  const int out_col = P::kSplitCols ? wg * P::kOutCols : 0;
  const uint32_t r_base = wgmma::smem_u32(r_tile) + group * kBoxBytes;
  // exp(S - lse) as 2^(S log2 e - lse log2 e): one fma and one ex2.approx
  const float lr2[2] = {sw.lse_r[ra] * kLog2e, sw.lse_r[ra + 8] * kLog2e};

  // The output accumulators take no zeros: the first tile's first product
  // step overwrites them (scale-d 0), so no instruction writes them while a
  // wgmma is in flight.
  float acc[P::kOutCols / 2];
  float s_even[P::kSCols / 2], s_odd[P::kSCols / 2];  // S of the even and the odd tiles

  // S_j = R T_j^T over D / 16 steps of depth 16 (the first step writes s
  // without reading it, so nothing else writes s while the previous tile's
  // product is in flight), issued and committed, not waited for
  auto issue_scores = [&](int j, float (&s)[P::kSCols / 2]) {
    wgmma::mbar_wait(&full[j % P::kStages], (j / P::kStages) & 1);
    const uint32_t t_base = wgmma::smem_u32(ring + (j % P::kStages) * P::kTileBytes);
    wgmma::fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const uint64_t a = wgmma::desc_sw128(r_base + (k / 4) * P::kRowGroups * kBoxBytes + (k % 4) * 32, 16, 1024);
      const uint64_t b = wgmma::desc_sw128(t_base + (k / 4) * kBoxBytes + s_col * 128 + (k % 4) * 32, 16, 1024);
      if constexpr (P::kSplitCols) {
        if (k == 0) {
          wgmma::mma_ss_first_m64n32k16<0>(s, a, b);
        } else {
          wgmma::mma_ss_m64n32k16<0>(s, a, b, 1);
        }
      } else {
        if (k == 0) {
          wgmma::mma_ss_first_m64n64k16<0>(s, a, b);
        } else {
          wgmma::mma_ss_m64n64k16<0>(s, a, b, 1);
        }
      }
    }
    wgmma::commit();
  };

  // Once S_j and out += A_{j-1} T_{j-1} have completed: releases tile j - 1's stage.
  auto scores_done = [&](int j, float (&s)[P::kSCols / 2]) {
    wgmma::wait<0>();
    wgmma::fence_operand(s);
    wgmma::fence_operand(acc);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) wgmma::mbar_arrive(&empty[(j - 1) % P::kStages]);
    }
  };

  // A_j from S_j, then out += A_j T_j issued and committed
  auto accumulate = [&](int j, const float (&s)[P::kSCols / 2]) {
    const uint32_t t_base = wgmma::smem_u32(ring + (j % P::kStages) * P::kTileBytes);
    const float* lse_c = ring_lse + (j % P::kStages) * kBox + s_col;  // the tile's column lse
    // A in place of S, packed to bf16: the 16-deep step kc of the second
    // product takes columns 16 kc .. 16 kc + 15 of this warpgroup's S
    uint32_t pa[P::kSCols / 16][4];
    const int col0 = j * kBox + s_col;
#pragma unroll
    for (int ns = 0; ns < P::kSCols / 8; ++ns) {
      const float2 lc = *reinterpret_cast<const float2*>(lse_c + ns * 8 + 2 * t);
      const float lc2[2] = {lc.x * kLog2e, lc.y * kLog2e};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + (e >> 1) * 8;
        const int col = col0 + ns * 8 + 2 * t + (e & 1);
        const float pc = exp2_approx(fmaf(s[4 * ns + e], kLog2e, -lc2[e & 1]));
        const float pr = exp2_approx(fmaf(s[4 * ns + e], kLog2e, -lr2[e >> 1]));
        float x = (pr + pc) - (col == row + sw.diag_shift ? diag_coef : 0.f);
        x = x - smooth_term;
        v[e] = inv2b * x;
      }
      pa[ns >> 1][(ns & 1) * 2 + 0] = tile_mma::pack_bf16x2(v[0], v[1]);
      pa[ns >> 1][(ns & 1) * 2 + 1] = tile_mma::pack_bf16x2(v[2], v[3]);
    }

    // out += A T, T read as MN-major: step kc is rows 16 kc .. 16 kc + 15 of
    // the tile, and the output columns out_col .. start at its depth box
    // out_col / 64 (the next 64 columns one box further)
    if constexpr (P::kSplitCols) {
      uint8_t* ab = a_tile + (j & 1) * kBoxBytes;
      const int r = warp * 16 + g;
#pragma unroll
      for (int kc = 0; kc < P::kSCols / 16; ++kc) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = s_col + kc * 16 + h * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ab + swizzled(r, c)) = pa[kc][h * 2];
          *reinterpret_cast<uint32_t*>(ab + swizzled(r + 8, c)) = pa[kc][h * 2 + 1];
        }
      }
      wgmma::fence_proxy_async();
      wgmma::named_barrier_sync(1, 256);  // both halves of A are in place
      wgmma::fence_operand(acc);
      wgmma::fence();
#pragma unroll
      for (int kc = 0; kc < kBox / 16; ++kc) {
        const uint64_t a = wgmma::desc_sw128(wgmma::smem_u32(ab) + kc * 32, 16, 1024);
        const uint64_t b = wgmma::desc_sw128(t_base + (out_col / 64) * kBoxBytes + kc * 2048, kBoxBytes, 1024);
        if constexpr (P::kOutCols == 256) {
          wgmma::mma_ss_m64n256k16<1>(acc, a, b, j > 0 || kc > 0);
        } else {
          wgmma::mma_ss_m64n192k16<1>(acc, a, b, j > 0 || kc > 0);
        }
      }
    } else {
      wgmma::fence_operand(acc);
      wgmma::fence();
#pragma unroll
      for (int kc = 0; kc < kBox / 16; ++kc) {
        const uint64_t b = wgmma::desc_sw128(t_base + kc * 2048, kBoxBytes, 1024);
        if constexpr (P::kOutCols == 256) {
          wgmma::mma_rs_m64n256k16<1>(acc, pa[kc], b, j > 0 || kc > 0);
        } else {
          wgmma::mma_rs_m64n128k16<1>(acc, pa[kc], b, j > 0 || kc > 0);
        }
      }
    }
    wgmma::commit();
  };

  wgmma::mbar_wait(full_r, 0);
  if constexpr (P::kOverlap) {
    // S_{j+1} runs on the tensor cores while this warpgroup forms A_j
    issue_scores(0, s_even);
    for (int j = 0; j < n_tiles; j += 2) {
      scores_done(j, s_even);
      if (j + 1 < n_tiles) issue_scores(j + 1, s_odd);
      accumulate(j, s_even);
      if (j + 1 == n_tiles) break;
      scores_done(j + 1, s_odd);
      if (j + 2 < n_tiles) issue_scores(j + 2, s_even);
      accumulate(j + 1, s_odd);
    }
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      issue_scores(j, s_even);
      scores_done(j, s_even);
      accumulate(j, s_even);
    }
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc);

  float* __restrict__ out = sw.out;
#pragma unroll
  for (int i = 0; i < P::kOutCols / 8; ++i) {
    const int col = out_col + i * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra) * D + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra + 8) * D + col) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* n, const void* c, const SweepW& dn, const SweepW& dc, int rows, int b,
                         float inv2b, float diag_coef, float smooth_term, cudaStream_t stream) {
  using P = Plan<D>;
  CUtensorMap map_n, map_c;
  cudaError_t err = wgmma::box_map(&map_n, n, rows, D);
  if (err == cudaSuccess) err = wgmma::box_map(&map_c, c, b, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ce_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const int dn_blocks = (rows + P::kBlockRows - 1) / P::kBlockRows;
  const int dc_blocks = (b + P::kBlockRows - 1) / P::kBlockRows;
  ce_bwd_wgmma<D><<<dn_blocks + dc_blocks, P::kThreads, P::kSmemBytes, stream>>>(
      map_n, map_c, dn, dc, dn_blocks, inv2b, diag_coef, smooth_term);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n [rows, d] bf16 (scaled by 1/tau), c [b, d] bf16, row_lse [rows] f32,
// col_lse [b] f32 -> dn [rows, d] f32, dc [b, d] f32 (dc summed over n's
// rows only). d a multiple of 128, rows and b multiples of 64; pointers
// 16-byte aligned (the wrapper checks). inv2b, diag_coef and smooth_term are the f32 constants
// 0.5 / B, 2 (1 - eps) and 2 eps / B of the TPU kernel.
int fused_ce_bwd(const void* n, const void* c, const void* row_lse, const void* col_lse,
                 void* dn, void* dc, int rows, int b, int d, float inv2b, float diag_coef,
                 float smooth_term, int row_offset, void* stream) {
  if (d <= 0 || d % kChunk || rows % kBM || b % kBM || rows <= 0 || b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rl = static_cast<const float*>(row_lse);
  const auto* cl = static_cast<const float*>(col_lse);
  if (d <= 512) {
    // dn: rows of N against the tiles of C, the diagonal at c == r + offset;
    // dc: rows of C against the tiles of N, the diagonal at n == c - offset
    const SweepW sw_dn{rl, cl, static_cast<float*>(dn), rows, b, row_offset};
    const SweepW sw_dc{cl, rl, static_cast<float*>(dc), b, rows, -row_offset};
    cudaError_t err;
    switch (d) {
      case 128: err = launch_wgmma<128>(n, c, sw_dn, sw_dc, rows, b, inv2b, diag_coef, smooth_term, s); break;
      case 256: err = launch_wgmma<256>(n, c, sw_dn, sw_dc, rows, b, inv2b, diag_coef, smooth_term, s); break;
      case 384: err = launch_wgmma<384>(n, c, sw_dn, sw_dc, rows, b, inv2b, diag_coef, smooth_term, s); break;
      default: err = launch_wgmma<512>(n, c, sw_dn, sw_dc, rows, b, inv2b, diag_coef, smooth_term, s); break;
    }
    return static_cast<int>(err);
  }
  const auto* nb = static_cast<const __nv_bfloat16*>(n);
  const auto* cb = static_cast<const __nv_bfloat16*>(c);
  const Sweep sweep_dn{nb, cb, rl, cl, static_cast<float*>(dn), b, row_offset};
  const Sweep sweep_dc{cb, nb, cl, rl, static_cast<float*>(dc), rows, -row_offset};
  const dim3 grid(rows / kBM + b / kBM, d / kChunk);
  ce_bwd_chunked<<<grid, kThreads, 0, s>>>(sweep_dn, sweep_dc, rows / kBM, d, inv2b, diag_coef, smooth_term);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block at width d: the wgmma branch's
// (0 past D = 512, where the chunked branch takes static shared memory).
int fused_ce_bwd_smem_bytes(int d) {
  switch (d) {
    case 128: return Plan<128>::kSmemBytes;
    case 256: return Plan<256>::kSmemBytes;
    case 384: return Plan<384>::kSmemBytes;
    case 512: return Plan<512>::kSmemBytes;
    default: return 0;
  }
}

const char* fused_ce_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
