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
// Design.
//  - same_tile_diag: each block takes 64 rows of N and the 64x64 tile of S
//    on their diagonal, through the same fragment loads, mma.sync shape and
//    depth order as the sweep (tile_mma.cuh: `zero_scores`, then
//    `chunk_scores` over the 128-deep chunks of D in order). With row_offset
//    a multiple of 64, the sweep's tile that holds S_ii is made of the same
//    operands in the same fragment positions, so the two values are equal
//    bit for bit at every D and rank compares each S_ij with the very value
//    S_ii takes in the sweep. The TPU needed the same rule
//    (fused_logits.py:518-527): a diagonal summed in another order miscounts
//    every S_ij within an ulp of it. The diagonal's own column is skipped by
//    index, never by value.
//  - the sweep, as the lean forward (fused_ce_fwd.cu): one block per 64 rows
//    walks every 64-column tile of C, each in 128-deep chunks double-buffered
//    in shared memory with cp.async; S tiles live only in registers; each
//    lane carries its two rows' online (max, sum of exp), plain sum and rank
//    over its columns, merged across the row's 4 lanes at the end. One
//    design serves both TPU kernels: the B <= 8192 one held all of C in VMEM
//    and the blocked one streamed it in column blocks; here C always streams.
//  - column statistics: each block writes, per column, (max, sum of exp
//    under that max, plain sum) over its 64 rows to a [3, rows/64, B] f32
//    workspace, and a second kernel merges them in block order. No atomics,
//    so two calls give the same bits. The workspace is 3 B rows / 16 bytes:
//    12.6 MB at rows = B = 8192, 805 MB at 65536.
//
// Bound: at B = 8192, D = 128 the products are 2 B^2 D = 17.2 GFLOP, 0.017
// ms at the 989 TFLOP/s bf16 peak; the shifted sums need 2 B^2 = 134M
// exponentials, 0.032 ms at the special-function units' 16 per clock and SM
// (132 SMs at 1.98 GHz): the exponentials bound it. The bytes (N, C in,
// the statistics out) are 4.3 MB.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes
// the workspace), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

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

// The sweep: row statistics in full, column partials per block. kOneChunk:
// D = 128, the chunk loop compiled away.
template <bool kOneChunk>
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

  // at D = 128 the row stride is a constant, as the address arithmetic was before chunking
  if (kOneChunk) d = kChunk;
  const int n_chunks = kOneChunk ? 1 : d / kChunk;
  uint32_t a[kChunkSteps][4];
  load_row_fragments(a, n, ra, t, d, 0);
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
    if (n_chunks > 1) load_row_fragments(a, n, ra, t, d, q * kChunk);
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
  same_tile_diag_kernel<<<rows / kBM, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(n), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(diag), row_offset, d);
  return static_cast<int>(cudaGetLastError());
}

// n, c as above, diag [rows] f32 from same_tile_diag -> row_stats [rows, 4]
// and col_stats [2, cols] f32; workspace 3 * (rows / 64) * cols f32.
int fused_stats_sweep(const void* n, const void* c, const void* diag, void* row_stats,
                      void* col_stats, void* workspace, int rows, int cols, int d, int row_offset,
                      void* stream) {
  if (!shapes_ok(rows, cols, d, row_offset)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_blocks = rows / kBM;
  const int64_t plane = static_cast<int64_t>(n_blocks) * cols;
  float* part_max = static_cast<float*>(workspace);
  float* part_exp = part_max + plane;
  float* part_sum = part_exp + plane;
  auto sweep = d == kChunk ? stats_sweep_kernel<true> : stats_sweep_kernel<false>;
  sweep<<<n_blocks, kThreads, 0, s>>>(
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

const char* fused_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
