// Lean forward of the bidirectional in-batch CE for Hopper (sm_90a): the
// softmax statistics of S = N C^T without writing S.
//
// Replaces the TPU kernels jodalrob_twotower_tpu/ops/fused_logits.py:241
// `_fwd_lean_kernel` and :280 `_fwd_lean_nomax_kernel` (B <= 8192, through
// `_fused_lean_call`) and :387 `_fwd_lean_blocked_kernel` (8192 < B <=
// 65536). For N [rows, D] (already scaled by 1/tau) and C [cols, D], both
// bf16, with f32 accumulation:
//
//   row_lse[i] = log sum_j exp(S[i, j])      col_lse[j] = log sum_i exp(S[i, j])
//
// "nomax" skips the max shift: the caller proves |S| <= 60 (unit-norm towers,
// 1/tau <= 60), so exp cannot overflow f32. Otherwise each state is a (max,
// sum of exp) pair, merged online.
//
// Bound. The function needs 2 rows cols D products and rows cols
// exponentials (two in the shifted form, one for each side's state): at
// B = 8192, D = 128 that is 17.2 GFLOP (0.017 ms at the 989 TFLOP/s bf16
// peak of an H100 SXM at 700 W) beside 67M exponentials (0.016 ms on the
// special-function units, 16 a cycle per SM); the bytes, 4.3 MB, are far
// below. So the tensor cores and the special-function units must run at once.
//
// Design (D <= 512): the warpgroup sweep of softmax_sweep.cuh, which the
// statistics sweep (fused_stats.cu) shares: units of a resident block of C
// against a 64-row tile of N streamed by TMA, split evenly over at most 132
// CTAs; wgmma m64nNWk16 S tiles in W consumer warpgroups that take turns;
// row partials per NW-column block and column states in registers across a
// CTA's range; lean_merge below merges them in a fixed order, launched as a
// programmatic dependent of the sweep.
// Measured (clock64 per phase, thread 0 of each consumer warpgroup, an
// instrumented copy at B = 8192, D = 128, unshifted, two warpgroups): per
// unit about 2,500 cycles, of which the exponentials about 1,100, the
// issue and the wait for S about 800, the waits for the ring and the block
// changes about 400: the tensor cores and the special-function units are
// each busy well under half the time.
// D > 512 (no configuration of either package uses it) takes the earlier
// mma.sync kernel: a block of 4 warps per 64 rows walks C in 128-deep
// chunks (tile_mma.cuh), with a [rows/64, cols] partial per column.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes the
// workspace and the grid, from the wrapper's lean_lse_launch_shape), and
// returns the first error of cudaFuncSetAttribute, the tensor maps'
// encoding or the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>
#include <stdint.h>

#include "softmax_sweep.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile_mma;
namespace sweep = softmax_sweep;

constexpr float kNegInf = -1e30f;  // the TPU kernel's -inf stand-in
constexpr unsigned kFull = 0xffffffffu;

// -- D > 512: mma.sync, one 64-row block per CTA ---------------------------------

constexpr int kBM = 64;            // rows per block
constexpr int kBN = 64;            // columns per tile of C
constexpr int kWarps = kBM / 16;   // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNSub = kBN / 8;     // 8-column mma tiles per column tile

// Chunk q of the kBN-row column tile j of c [cols, d] into shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* c, int j, int q,
                                          int d, int tid) {
  load_chunk_async<kBN, kThreads>(dst, c + static_cast<int64_t>(j) * kBN * d + q * kChunk, d, tid);
}

template <bool kNoMax>
__global__ void __launch_bounds__(kThreads)
lean_lse_chunked(const __nv_bfloat16* __restrict__ n, const __nv_bfloat16* __restrict__ c,
                float* __restrict__ row_lse, float* __restrict__ part_max,
                float* __restrict__ part_sum, int cols, int d) {
  __shared__ __align__(16) __nv_bfloat16 tile[2][kBN * kChunkLd];
  __shared__ float col_red[kWarps][kBN];
  __shared__ float col_max[kBN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kBM + warp * 16 + g;  // this lane's rows: ra and ra + 8

  const int n_chunks = d / kChunk;
  uint32_t a[kChunkSteps][4];

  // this lane's share of its two rows: running max (shifted form) and sum of exp
  float rm[2] = {kNegInf, kNegInf};
  float rl[2] = {0.f, 0.f};

  // items: (column tile j, depth chunk q), q fastest; item i sits in tile[i & 1]
  const int n_tiles = cols / kBN;
  const int n_items = n_tiles * n_chunks;
  load_tile(tile[0], c, 0, 0, d, tid);
  cp_async_commit();
  float s[kNSub][4];
  for (int i = 0, j = 0, q = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      const int j1 = q + 1 < n_chunks ? j : j + 1, q1 = q + 1 < n_chunks ? q + 1 : 0;
      load_tile(tile[(i + 1) & 1], c, j1, q1, d, tid);
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

    // cv[ns][e]: this lane's two rows' contribution to column ns*8 + 2t + e
    float cv[kNSub][2];
    if constexpr (kNoMax) {
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float e0 = __expf(s[ns][e]), e1 = __expf(s[ns][2 + e]);
          rl[0] += e0;
          rl[1] += e1;
          cv[ns][e] = e0 + e1;
        }
      }
    } else {
      float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          tmax0 = fmaxf(tmax0, s[ns][e]);
          tmax1 = fmaxf(tmax1, s[ns][2 + e]);
          cv[ns][e] = fmaxf(s[ns][e], s[ns][2 + e]);
        }
      }
      const float nm0 = fmaxf(rm[0], tmax0), nm1 = fmaxf(rm[1], tmax1);
      float add0 = 0.f, add1 = 0.f;
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          add0 += __expf(s[ns][e] - nm0);
          add1 += __expf(s[ns][2 + e] - nm1);
        }
      }
      rl[0] = rl[0] * __expf(rm[0] - nm0) + add0;
      rl[1] = rl[1] * __expf(rm[1] - nm1) + add1;
      rm[0] = nm0;
      rm[1] = nm1;
      // the tile's column max over the block's 64 rows
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cv[ns][e] = fmaxf(cv[ns][e], __shfl_xor_sync(kFull, cv[ns][e], off));
          }
          if (g == 0) col_red[warp][ns * 8 + 2 * t + e] = cv[ns][e];
        }
      }
      __syncthreads();
      if (tid < kBN) {
        col_max[tid] = fmaxf(fmaxf(col_red[0][tid], col_red[1][tid]),
                             fmaxf(col_red[2][tid], col_red[3][tid]));
      }
      __syncthreads();
#pragma unroll
      for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = col_max[ns * 8 + 2 * t + e];
          cv[ns][e] = __expf(s[ns][e] - m) + __expf(s[ns][2 + e] - m);
        }
      }
    }

    // column sums over the warp's 16 rows, then over the block's 4 warps
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cv[ns][e] += __shfl_xor_sync(kFull, cv[ns][e], off);
        }
        if (g == 0) col_red[warp][ns * 8 + 2 * t + e] = cv[ns][e];
      }
    }
    __syncthreads();
    if (tid < kBN) {
      const int64_t o = static_cast<int64_t>(blockIdx.x) * cols + static_cast<int64_t>(j) * kBN + tid;
      part_sum[o] = (col_red[0][tid] + col_red[1][tid]) + (col_red[2][tid] + col_red[3][tid]);
      if constexpr (!kNoMax) part_max[o] = col_max[tid];
    }
    __syncthreads();  // the tile buffer and col_red are reused next iteration
    ++j;
    q = 0;
  }

  // merge each row's state across the 4 lanes that hold its columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      if constexpr (kNoMax) {
        rl[r] += __shfl_xor_sync(kFull, rl[r], off);
      } else {
        const float om = __shfl_xor_sync(kFull, rm[r], off);
        const float ol = __shfl_xor_sync(kFull, rl[r], off);
        const float m = fmaxf(rm[r], om);
        rl[r] = rl[r] * __expf(rm[r] - m) + ol * __expf(om - m);
        rm[r] = m;
      }
    }
  }
  if (t == 0) {
    row_lse[ra] = kNoMax ? logf(rl[0]) : logf(rl[0]) + rm[0];
    row_lse[ra + 8] = kNoMax ? logf(rl[1]) : logf(rl[1]) + rm[1];
  }
}

// col_lse[j] from the row blocks' partials, merged in block order.
template <bool kNoMax>
__global__ void chunked_col_lse(const float* __restrict__ part_max,
                               const float* __restrict__ part_sum, float* __restrict__ col_lse,
                               int n_blocks, int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  if constexpr (kNoMax) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += part_sum[static_cast<int64_t>(b) * cols + j];
    col_lse[j] = logf(s);
  } else {
    float m = kNegInf;
    for (int b = 0; b < n_blocks; ++b) m = fmaxf(m, part_max[static_cast<int64_t>(b) * cols + j]);
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) {
      const int64_t o = static_cast<int64_t>(b) * cols + j;
      s += part_sum[o] * __expf(part_max[o] - m);
    }
    col_lse[j] = logf(s) + m;
  }
}

template <bool kNoMax>
cudaError_t launch_chunked(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace,
                           int rows, int cols, int d, cudaStream_t stream) {
  const int n_blocks = rows / kBM;
  float* part_sum = static_cast<float*>(workspace);
  float* part_max = part_sum + static_cast<int64_t>(n_blocks) * cols;
  lean_lse_chunked<kNoMax><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(n), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(row_lse), part_max, part_sum, cols, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunked_col_lse<kNoMax><<<(cols + 255) / 256, 256, 0, stream>>>(
      part_max, part_sum, static_cast<float*>(col_lse), n_blocks, cols);
  return cudaGetLastError();
}

// -- D <= 512: the warpgroup sweep (softmax_sweep.cuh) --------------------------

// row_lse and col_lse from the partials, each merged in a fixed order: a row
// over its NW-column blocks, a column over the CTAs whose ranges cover its
// block.
template <bool kNoMax>
__global__ void lean_merge(const float* __restrict__ ws_row, const float* __restrict__ ws_col,
                           float* __restrict__ row_lse, float* __restrict__ col_lse, sweep::Work w, int row_parts,
                           int block_cols) {
  // launched behind the sweep with programmatic stream serialization: its
  // launch overlaps the sweep's tail, and here it waits for the sweep's
  // writes
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* base;
  int64_t stride;
  int parts;
  float* out;
  if (i < w.rows) {
    base = ws_row + (kNoMax ? i : 2 * i);
    stride = w.rows;
    parts = row_parts;
    out = row_lse + i;
  } else if (i < w.rows + w.cols) {
    const int j = i - w.rows;
    base = ws_col + (kNoMax ? j : 2 * j);
    stride = w.cols;
    parts = sweep::col_parts_of_block(j / block_cols, w);
    out = col_lse + j;
  } else {
    return;
  }
  if constexpr (kNoMax) {
    float sum = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) sum += base[p * stride];
    *out = sweep::kLn2 * log2f(sum);
  } else {
    // one pass, an online merge of (sum, max) pairs in part order
    float m = kNegInf, sum = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {
      const float2 v = *reinterpret_cast<const float2*>(base + 2 * p * stride);
      if (v.y > m) {
        sum = sum * exp2f(m - v.y) + v.x;
        m = v.y;
      } else {
        sum += v.x * exp2f(v.y - m);
      }
    }
    *out = sweep::kLn2 * (m + log2f(sum));
  }
}

template <int D, bool kNoMax>
cudaError_t launch_wgmma(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace, int rows,
                         int cols, int ctas, cudaStream_t stream) {
  using P = sweep::Plan<D, kNoMax>;
  const int row_parts = (cols + P::kNW - 1) / P::kNW;
  float* ws_row = static_cast<float*>(workspace);  // [row_parts][rows], a float2 each when shifted
  float* ws_col = ws_row + 2 * static_cast<int64_t>(row_parts) * rows;  // [pieces][cols], likewise
  sweep::Work w;
  const cudaError_t err =
      sweep::launch_sweep<D, kNoMax, false>(n, c, ws_row, ws_col, &w, rows, cols, ctas, nullptr, 0, stream);
  if (err != cudaSuccess) return err;
  return sweep::launch_dependent(lean_merge<kNoMax>, (rows + cols + 255) / 256, stream, ws_row, ws_col,
                                 static_cast<float*>(row_lse), static_cast<float*>(col_lse), w, row_parts,
                                 P::kBlockCols);
}

template <bool kNoMax>
cudaError_t launch(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace, int rows, int cols,
                   int d, int ctas, cudaStream_t s) {
  switch (d) {
    case 128: return launch_wgmma<128, kNoMax>(n, c, row_lse, col_lse, workspace, rows, cols, ctas, s);
    case 256: return launch_wgmma<256, kNoMax>(n, c, row_lse, col_lse, workspace, rows, cols, ctas, s);
    case 384: return launch_wgmma<384, kNoMax>(n, c, row_lse, col_lse, workspace, rows, cols, ctas, s);
    case 512: return launch_wgmma<512, kNoMax>(n, c, row_lse, col_lse, workspace, rows, cols, ctas, s);
    default: return launch_chunked<kNoMax>(n, c, row_lse, col_lse, workspace, rows, cols, d, s);
  }
}

}  // namespace

extern "C" {

// n [rows, d] bf16 (scaled by 1/tau), c [cols, d] bf16, row_lse [rows]
// f32, col_lse [cols] f32; d a multiple of 128, rows and cols multiples of
// 64, all pointers 16-byte aligned (the wrapper checks). ctas and the
// workspace's size come from the wrapper's lean_lse_launch_shape: up to
// D = 512, 2 (ceil(cols / NW) rows + pieces cols) f32 and ctas the grid
// (at most the units); past it, 2 (rows / 64) cols f32 and ctas unread.
int fused_lean_lse(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace, int rows,
                   int cols, int d, int nomax, int ctas, void* stream) {
  if (d <= 0 || d % kChunk || rows % kBM || cols % kBN || rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nomax ? launch<true>(n, c, row_lse, col_lse, workspace, rows, cols, d, ctas, s)
                                : launch<false>(n, c, row_lse, col_lse, workspace, rows, cols, d, ctas, s));
}

// Dynamic shared memory of one CTA at width d and form nomax: the wgmma
// branch's (0 past D = 512, where the mma.sync branch takes static shared
// memory).
int fused_lean_lse_smem_bytes(int d, int nomax) {
  switch (d) {
    case 128: return nomax ? sweep::Plan<128, true>::kSmemBytes : sweep::Plan<128, false>::kSmemBytes;
    case 256: return nomax ? sweep::Plan<256, true>::kSmemBytes : sweep::Plan<256, false>::kSmemBytes;
    case 384: return nomax ? sweep::Plan<384, true>::kSmemBytes : sweep::Plan<384, false>::kSmemBytes;
    case 512: return nomax ? sweep::Plan<512, true>::kSmemBytes : sweep::Plan<512, false>::kSmemBytes;
    default: return 0;
  }
}

const char* fused_lean_lse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
