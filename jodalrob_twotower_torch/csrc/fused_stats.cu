// Statistics of the in-batch similarity matrix for Hopper (sm_90a), without
// writing it: everything the evaluation metrics and the label-smoothed loss
// need, and the diagonal they rank against.
//
// Replaces the TPU kernels jodalrob_twotower_tpu/ops/fused_logits.py:95
// `_fwd_kernel` (through `_fused_stats_call`, B <= 8192), :553
// `_fwd_stats_blocked_kernel` (through `_fused_stats_blocked_call`,
// 8192 < B <= 65536) and :518 `_diag_mxu_kernel` (through `_diag_mxu_call`).
// For N [rows, D] (already scaled by 1/tau) and C [B, D], both bf16, with f32
// accumulation, the global row index row_offset of N's first row (0 on one
// device) and diag[i] = S[i, i + row_offset] from same_tile_diag:
//
//   row_stats[i] = (log sum_j exp S_ij, sum_j S_ij, diag_i,
//                   #{j != i + row_offset : S_ij > diag_i})          [rows, 4]
//   col_stats    = (log sum_i exp S_ij, sum_i S_ij) over N's rows    [2, B]
//
// Design, up to D = 512 (every configuration of either package):
//  - the sweep is the warpgroup sweep of softmax_sweep.cuh in its shifted
//    form with kStats, shared with the lean CE forward (fused_ce_fwd.cu):
//    units of a resident block of C (W 64-column warpgroup slices, W = 3 up
//    to D = 256, else 2) against a 64-row tile of N streamed by TMA, split
//    evenly over at most 132 CTAs (the wrapper's stats_launch_shape);
//    wgmma m64n64k16 S tiles; per element the shifted sums of exp (one
//    exponential a side, the column max moving lazily by 2^8), a plain row
//    and column sum, and one comparison against the row's diagonal for rank,
//    the diagonal's own column (row + row_offset) left out by index, never
//    by value. A row's partial per (row, 64-column slice) is a float4 (sum
//    of exp2, max, plain sum, rank); a column's state stays in registers
//    across a CTA's range and goes out once per CTA whose range meets its
//    block. stats_merge merges both in a fixed order (rows by column slice,
//    columns by CTA, eight lanes to a row or column joined in a fixed xor
//    tree; rank's partials are integers), launched as a programmatic
//    dependent of the sweep, so two calls give the same bits.
//    Workspace: 16 (rows B / 64 + pieces B) bytes, pieces at most a few
//    (16.6 MiB at rows = B = 8192, 1026 MiB at 65536).
//  - same_tile_diag: each CTA takes 64 rows of N and the 64 columns of C on
//    their diagonal by TMA into the sweep's shared layout (128-byte swizzle,
//    K-major [64, 64] boxes) and forms that [64, 64] tile of S with the
//    sweep's instruction (wgmma m64n64k16, the first step overwriting the
//    accumulators) over the same depth steps in the same order. With
//    row_offset a multiple of 64, the sweep's warpgroup slice that holds
//    S_ii starts at the same column (64 (i / 64) + row_offset) and forms it
//    from the same operands in the same accumulator position, so the two
//    values are equal bit for bit at every D and rank compares each S_ij
//    with the very value S_ii takes in the sweep. The TPU needed the same
//    rule (fused_logits.py:518-527): a diagonal summed in another order
//    miscounts every S_ij within an ulp of it.
// Past D = 512 (no configuration uses it) the earlier mma.sync kernels stay,
// the pair bound by the same rule through tile_mma.cuh: one block of 4 warps
// per 64 rows walks every 64-column tile of C in 128-deep chunks
// (double-buffered cp.async), each lane carrying its rows' states; column
// partials (max, sum of exp, plain sum) per row block go to a [3, rows/64,
// B] f32 workspace that col_stats_kernel merges in block order.
//
// Bound: at B = 8192, D = 128 the products are 2 B^2 D = 17.2 GFLOP, 0.017
// ms at the 989 TFLOP/s bf16 peak; the shifted sums need 2 B^2 = 134M
// exponentials, 0.032 ms at the special-function units' 16 per clock and SM
// (132 SMs at 1.98 GHz): the exponentials bound it. The bytes (N, C in,
// the statistics out) are 4.3 MB.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes
// the workspace and the sweep's grid, from the wrapper's
// stats_launch_shape), and returns the first error of cudaFuncSetAttribute,
// the tensor maps' encoding or the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_sweep.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile_mma;
namespace sweep = softmax_sweep;

constexpr int kBM = 64;            // rows per block
constexpr int kBN = 64;            // columns per tile of C: equal to kBM, so a
                                   // block's diagonal lies in one tile
constexpr int kWarps = kBM / 16;   // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNSub = kBN / 8;     // 8-column mma tiles per column tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's -inf stand-in
constexpr unsigned kFull = 0xffffffffu;

// Chunk q of the kBN rows of c [*, d] from row r0 into shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* c, int64_t r0,
                                          int q, int d, int tid) {
  load_chunk_async<kBN, kThreads>(dst, c + r0 * d + q * kChunk, d, tid);
}

// -- D > 512: mma.sync ------------------------------------------------------------

// diag[r] = S[r, r + row_offset] for the block's 64 rows.
__global__ void __launch_bounds__(kThreads)
same_tile_diag_kernel(const __nv_bfloat16* __restrict__ n, const __nv_bfloat16* __restrict__ c,
                      float* __restrict__ diag, int row_offset, int d) {
  __shared__ __align__(16) __nv_bfloat16 tile[kBN * kChunkLd];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kBM;
  const int ra = r0 + warp * 16 + g;  // this lane's rows: ra and ra + 8

  float s[kNSub][4];
  zero_scores(s);
  uint32_t a[kChunkSteps][4];
  for (int q = 0; q < d / kChunk; ++q) {
    load_tile(tile, c, r0 + row_offset, q, d, tid);
    cp_async_commit();
    load_row_fragments(a, n, ra, t, d, q * kChunk);
    cp_async_wait<0>();
    __syncthreads();
    chunk_scores(s, a, tile, g, t);
    __syncthreads();  // the buffer is refilled next chunk
  }
#pragma unroll
  for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = warp * 16 + g + (q >> 1) * 8;  // in the block
      const int col = ns * 8 + 2 * t + (q & 1);      // in the tile
      if (col == row) diag[r0 + row] = s[ns][q];
    }
  }
}

// The sweep: row statistics in full, column partials per block.
__global__ void __launch_bounds__(kThreads)
stats_sweep_kernel(const __nv_bfloat16* __restrict__ n, const __nv_bfloat16* __restrict__ c,
                   const float* __restrict__ diag, float* __restrict__ row_stats,
                   float* __restrict__ part_max, float* __restrict__ part_exp,
                   float* __restrict__ part_sum, int cols, int row_offset, int d) {
  __shared__ __align__(16) __nv_bfloat16 tile[2][kBN * kChunkLd];
  __shared__ float red_max[kWarps][kBN];
  __shared__ float red_exp[kWarps][kBN];
  __shared__ float red_sum[kWarps][kBN];
  __shared__ float col_max[kBN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kBM + warp * 16 + g;  // this lane's rows: ra and ra + 8

  const int n_chunks = d / kChunk;
  uint32_t a[kChunkSteps][4];
  const float dg[2] = {diag[ra], diag[ra + 8]};
  const int dcol[2] = {ra + row_offset, ra + 8 + row_offset};

  // this lane's share of its two rows
  float rm[2] = {kNegInf, kNegInf};  // running max
  float rl[2] = {0.f, 0.f};          // sum of exp(S - rm)
  float rs[2] = {0.f, 0.f};          // sum of S
  int rk[2] = {0, 0};                // entries above the diagonal

  // items: (column tile j, depth chunk q), q fastest; item i sits in tile[i & 1]
  const int n_tiles = cols / kBN;
  const int n_items = n_tiles * n_chunks;
  load_tile(tile[0], c, 0, 0, d, tid);
  cp_async_commit();
  float s[kNSub][4];
  for (int i = 0, j = 0, q = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      const int j1 = q + 1 < n_chunks ? j : j + 1, q1 = q + 1 < n_chunks ? q + 1 : 0;
      load_tile(tile[(i + 1) & 1], c, static_cast<int64_t>(j1) * kBN, q1, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    load_row_fragments(a, n, ra, t, d, q * kChunk);
    if (q == 0) zero_scores(s);
    chunk_scores(s, a, tile[i & 1], g, t);
    if (q + 1 < n_chunks) {
      ++q;
      __syncthreads();  // the buffer is refilled next iteration
      continue;
    }

    // rows: max, sum, rank; columns: this lane's two rows' max and sum
    float tmax[2] = {kNegInf, kNegInf};
    float cm[kNSub][2], cs[kNSub][2];
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * kBN + ns * 8 + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = s[ns][2 * r + e];
          tmax[r] = fmaxf(tmax[r], v);
          rs[r] += v;
          rk[r] += (col != dcol[r] && v > dg[r]) ? 1 : 0;
        }
        cm[ns][e] = fmaxf(s[ns][e], s[ns][2 + e]);
        cs[ns][e] = s[ns][e] + s[ns][2 + e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(rm[r], tmax[r]);
      float add = 0.f;
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
        add += __expf(s[ns][2 * r] - nm) + __expf(s[ns][2 * r + 1] - nm);
      }
      rl[r] = rl[r] * __expf(rm[r] - nm) + add;
      rm[r] = nm;
    }

    // the tile's column max and plain sum over the warp's 16 rows, then the block's 4 warps
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cm[ns][e] = fmaxf(cm[ns][e], __shfl_xor_sync(kFull, cm[ns][e], off));
          cs[ns][e] += __shfl_xor_sync(kFull, cs[ns][e], off);
        }
        if (g == 0) {
          red_max[warp][ns * 8 + 2 * t + e] = cm[ns][e];
          red_sum[warp][ns * 8 + 2 * t + e] = cs[ns][e];
        }
      }
    }
    __syncthreads();
    if (tid < kBN) {
      col_max[tid] = fmaxf(fmaxf(red_max[0][tid], red_max[1][tid]),
                           fmaxf(red_max[2][tid], red_max[3][tid]));
    }
    __syncthreads();
    // the column sums of exp under the block's column max
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m = col_max[ns * 8 + 2 * t + e];
        float ce = __expf(s[ns][e] - m) + __expf(s[ns][2 + e] - m);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) ce += __shfl_xor_sync(kFull, ce, off);
        if (g == 0) red_exp[warp][ns * 8 + 2 * t + e] = ce;
      }
    }
    __syncthreads();
    if (tid < kBN) {
      const int64_t o = static_cast<int64_t>(blockIdx.x) * cols + static_cast<int64_t>(j) * kBN + tid;
      part_max[o] = col_max[tid];
      part_exp[o] = (red_exp[0][tid] + red_exp[1][tid]) + (red_exp[2][tid] + red_exp[3][tid]);
      part_sum[o] = (red_sum[0][tid] + red_sum[1][tid]) + (red_sum[2][tid] + red_sum[3][tid]);
    }
    __syncthreads();  // the tile buffer and the reduction arrays are reused next iteration
    ++j;
    q = 0;
  }

  // merge each row's state across the 4 lanes that hold its columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(kFull, rm[r], off);
      const float ol = __shfl_xor_sync(kFull, rl[r], off);
      const float m = fmaxf(rm[r], om);
      rl[r] = rl[r] * __expf(rm[r] - m) + ol * __expf(om - m);
      rm[r] = m;
      rs[r] += __shfl_xor_sync(kFull, rs[r], off);
      rk[r] += __shfl_xor_sync(kFull, rk[r], off);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float4*>(row_stats + static_cast<int64_t>(ra + 8 * r) * 4) =
          make_float4(logf(rl[r]) + rm[r], rs[r], dg[r], static_cast<float>(rk[r]));
    }
  }
}

// col_stats [2, cols] (lse, sum) from the row blocks' partials, merged in block order.
__global__ void col_stats_kernel(const float* __restrict__ part_max,
                                 const float* __restrict__ part_exp,
                                 const float* __restrict__ part_sum, float* __restrict__ col_stats,
                                 int n_blocks, int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float m = kNegInf;
  for (int b = 0; b < n_blocks; ++b) m = fmaxf(m, part_max[static_cast<int64_t>(b) * cols + j]);
  float e = 0.f, s = 0.f;
  for (int b = 0; b < n_blocks; ++b) {
    const int64_t o = static_cast<int64_t>(b) * cols + j;
    e += part_exp[o] * __expf(part_max[o] - m);
    s += part_sum[o];
  }
  col_stats[j] = logf(e) + m;
  col_stats[cols + j] = s;
}

// -- D <= 512: the warpgroup sweep -----------------------------------------------

// diag[r] = S[r, r + row_offset] for the CTA's 64 rows: the [64, 64] tile of
// S on their diagonal, formed as the sweep forms it.
template <int D>
__global__ void __launch_bounds__(128)
same_tile_diag_wgmma(const __grid_constant__ CUtensorMap map_n, const __grid_constant__ CUtensorMap map_c,
                     float* __restrict__ diag, int row_offset) {
  constexpr int kBoxes = D / sweep::kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tile_n = smem;                                // [kBoxes] boxes: the rows' depth in order
  uint8_t* tile_c = smem + kBoxes * sweep::kBoxBytes;    // [kBoxes] boxes: their diagonal's columns
  auto* bar = reinterpret_cast<uint64_t*>(tile_c + kBoxes * sweep::kBoxBytes);
  const int r0 = blockIdx.x * sweep::kBox;
  if (threadIdx.x == 0) {
    wgmma::mbar_init(bar, 1);
    wgmma::fence_barrier_init();
    wgmma::mbar_expect_tx(bar, 2 * kBoxes * sweep::kBoxBytes);
    for (int kb = 0; kb < kBoxes; ++kb) {
      wgmma::tma_load_2d(tile_n + kb * sweep::kBoxBytes, &map_n, kb * sweep::kBox, r0, bar);
      wgmma::tma_load_2d(tile_c + kb * sweep::kBoxBytes, &map_c, kb * sweep::kBox, r0 + row_offset, bar);
    }
  }
  __syncthreads();
  wgmma::mbar_wait(bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t n_base = wgmma::smem_u32(tile_n), c_base = wgmma::smem_u32(tile_c);
  float s[32];
  wgmma::fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {  // the sweep's depth steps, in its order
    const uint64_t a = wgmma::desc_sw128(n_base + (k / 4) * sweep::kBoxBytes + (k % 4) * 32, 16, 1024);
    const uint64_t b = wgmma::desc_sw128(c_base + (k / 4) * sweep::kBoxBytes + (k % 4) * 32, 16, 1024);
    if (k == 0) {
      wgmma::mma_ss_first_m64n64k16<0>(s, a, b);
    } else {
      wgmma::mma_ss_m64n64k16<0>(s, a, b, 1);
    }
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(s);
  // s[4i + e]: row 16 warp + g, column 8i + 2t + e; s[4i + 2 + e]: row + 8
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * t + e, row = warp * 16 + g;
      if (col == row) diag[r0 + row] = s[4 * i + e];
      if (col == row + 8) diag[r0 + row + 8] = s[4 * i + 2 + e];
    }
  }
}

// row_stats [rows, 4] and col_stats [2, cols] from the sweep's float4
// partials, each merged in a fixed order: a row over its 64-column slices,
// a column over the CTAs whose ranges meet its block. kLanes lanes take one
// row or column: lane l merges parts l, l + kLanes, ... in order, and the
// lanes' states combine in a fixed tree (xor 1, 2, 4), so the partials are
// read kLanes at a time (a row has B / 64 of them: 256 at B = 16384).
constexpr int kMergeLanes = 8;

__device__ __forceinline__ void merge_state(float& m, float& sum, float om, float osum) {
  if (om > m) {
    sum = sum * exp2f(m - om) + osum;
    m = om;
  } else {
    sum += osum * exp2f(om - m);
  }
}

__global__ void stats_merge(const float4* __restrict__ ws_row, const float4* __restrict__ ws_col,
                            const float* __restrict__ diag, float* __restrict__ row_stats,
                            float* __restrict__ col_stats, sweep::Work w, int row_parts, int block_cols) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the sweep's writes
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kMergeLanes;
  const int lane = threadIdx.x % kMergeLanes;
  if (i >= w.rows + w.cols) return;  // whole groups of kMergeLanes leave together
  const float4* base;
  int64_t stride;
  int parts;
  if (i < w.rows) {
    base = ws_row + i;
    stride = w.rows;
    parts = row_parts;
  } else {
    base = ws_col + (i - w.rows);
    stride = w.cols;
    parts = sweep::col_parts_of_block((i - w.rows) / block_cols, w);
  }
  // this lane's parts: an online merge of (sum of exp2, max), the plain sums and ranks beside it
  float m = kNegInf, sum = 0.f, plain = 0.f;
  int rank = 0;
#pragma unroll 4
  for (int p = lane; p < parts; p += kMergeLanes) {
    const float4 v = base[p * stride];
    merge_state(m, sum, v.y, v.x);
    plain += v.z;
    rank += static_cast<int>(v.w);
  }
  const unsigned group = ((1u << kMergeLanes) - 1) << (threadIdx.x % 32 / kMergeLanes * kMergeLanes);
#pragma unroll
  for (int off = 1; off < kMergeLanes; off <<= 1) {
    const float om = __shfl_xor_sync(group, m, off), osum = __shfl_xor_sync(group, sum, off);
    merge_state(m, sum, om, osum);
    plain += __shfl_xor_sync(group, plain, off);
    rank += __shfl_xor_sync(group, rank, off);
  }
  if (lane) return;
  const float lse = sweep::kLn2 * (m + log2f(sum));
  if (i < w.rows) {
    *reinterpret_cast<float4*>(row_stats + static_cast<int64_t>(i) * 4) =
        make_float4(lse, plain, diag[i], static_cast<float>(rank));
  } else {
    const int j = i - w.rows;
    col_stats[j] = lse;
    col_stats[w.cols + j] = plain;
  }
}

template <int D>
constexpr int diag_smem_bytes() {
  return 1024 + 2 * (D / sweep::kBox) * sweep::kBoxBytes + 16;
}

template <int D>
cudaError_t diag_wgmma(const void* n, const void* c, void* diag, int rows, int cols, int row_offset,
                       cudaStream_t stream) {
  CUtensorMap map_n, map_c;
  cudaError_t err = wgmma::box_map(&map_n, n, rows, D);
  if (err == cudaSuccess) err = wgmma::box_map(&map_c, c, cols, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(same_tile_diag_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               diag_smem_bytes<D>());
  }
  if (err != cudaSuccess) return err;
  same_tile_diag_wgmma<D><<<rows / sweep::kBox, 128, diag_smem_bytes<D>(), stream>>>(
      map_n, map_c, static_cast<float*>(diag), row_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t stats_wgmma(const void* n, const void* c, const void* diag, void* row_stats, void* col_stats,
                        void* workspace, int rows, int cols, int row_offset, int ctas, cudaStream_t stream) {
  using P = sweep::Plan<D, false, true>;
  const int row_parts = cols / P::kNW;
  auto* ws_row = static_cast<float*>(workspace);                   // [row_parts][rows] float4
  float* ws_col = ws_row + 4 * static_cast<int64_t>(row_parts) * rows;  // [pieces][cols] float4
  sweep::Work w;
  const cudaError_t err = sweep::launch_sweep<D, false, true>(n, c, ws_row, ws_col, &w, rows, cols, ctas,
                                                              static_cast<const float*>(diag), row_offset, stream);
  if (err != cudaSuccess) return err;
  return sweep::launch_dependent(stats_merge, ((rows + cols) * kMergeLanes + 255) / 256, stream,
                                 reinterpret_cast<const float4*>(ws_row), reinterpret_cast<const float4*>(ws_col),
                                 static_cast<const float*>(diag), static_cast<float*>(row_stats),
                                 static_cast<float*>(col_stats), w, row_parts, P::kBlockCols);
}

bool shapes_ok(int rows, int cols, int d, int row_offset) {
  return d > 0 && d % kChunk == 0 && rows > 0 && cols > 0 && rows % kBM == 0 && cols % kBN == 0 &&
         row_offset >= 0 && row_offset % kBM == 0 && row_offset <= cols - rows;
}

}  // namespace

extern "C" {

// n [rows, d] bf16 (scaled by 1/tau), c [cols, d] bf16 -> diag [rows] f32,
// diag[i] = S[i, i + row_offset]. d a multiple of 128; rows, cols and
// row_offset multiples of 64, row_offset + rows <= cols; pointers 16-byte
// aligned (the wrapper checks).
int same_tile_diag(const void* n, const void* c, void* diag, int rows, int cols, int d,
                   int row_offset, void* stream) {
  if (!shapes_ok(rows, cols, d, row_offset)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return static_cast<int>(diag_wgmma<128>(n, c, diag, rows, cols, row_offset, s));
    case 256: return static_cast<int>(diag_wgmma<256>(n, c, diag, rows, cols, row_offset, s));
    case 384: return static_cast<int>(diag_wgmma<384>(n, c, diag, rows, cols, row_offset, s));
    case 512: return static_cast<int>(diag_wgmma<512>(n, c, diag, rows, cols, row_offset, s));
    default: break;
  }
  same_tile_diag_kernel<<<rows / kBM, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(n), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(diag), row_offset, d);
  return static_cast<int>(cudaGetLastError());
}

// n, c as above, diag [rows] f32 from same_tile_diag -> row_stats [rows, 4]
// and col_stats [2, cols] f32. ctas and the workspace's size come from the
// wrapper's stats_launch_shape: up to D = 512, 4 (cols / 64 rows + pieces
// cols) f32 and ctas the sweep's grid (at most its units); past it,
// 3 (rows / 64) cols f32 and ctas unread.
int fused_stats_sweep(const void* n, const void* c, const void* diag, void* row_stats,
                      void* col_stats, void* workspace, int rows, int cols, int d, int row_offset,
                      int ctas, void* stream) {
  if (!shapes_ok(rows, cols, d, row_offset)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define STATS_WGMMA(D)                                                                                      \
  case D:                                                                                                   \
    return static_cast<int>(                                                                                \
        stats_wgmma<D>(n, c, diag, row_stats, col_stats, workspace, rows, cols, row_offset, ctas, s));
    STATS_WGMMA(128)
    STATS_WGMMA(256)
    STATS_WGMMA(384)
    STATS_WGMMA(512)
#undef STATS_WGMMA
    default: break;
  }
  const int n_blocks = rows / kBM;
  const int64_t plane = static_cast<int64_t>(n_blocks) * cols;
  float* part_max = static_cast<float*>(workspace);
  float* part_exp = part_max + plane;
  float* part_sum = part_exp + plane;
  stats_sweep_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(n), static_cast<const __nv_bfloat16*>(c),
      static_cast<const float*>(diag), static_cast<float*>(row_stats), part_max, part_exp,
      part_sum, cols, row_offset, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  col_stats_kernel<<<(cols + 255) / 256, 256, 0, s>>>(part_max, part_exp, part_sum,
                                                        static_cast<float*>(col_stats), n_blocks,
                                                        cols);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one sweep CTA at width d (0 past D = 512, where
// the mma.sync sweep takes static shared memory).
int fused_stats_smem_bytes(int d) {
  switch (d) {
    case 128: return sweep::Plan<128, false, true>::kSmemBytes;
    case 256: return sweep::Plan<256, false, true>::kSmemBytes;
    case 384: return sweep::Plan<384, false, true>::kSmemBytes;
    case 512: return sweep::Plan<512, false, true>::kSmemBytes;
    default: return 0;
  }
}

const char* fused_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
