// Lean forward of the bidirectional in-batch CE for Hopper (sm_90a): the
// softmax statistics of S = N C^T without writing S.
//
// Replaces the TPU kernels jodalrob_twotower_tpu/ops/fused_logits.py:241
// `_fwd_lean_kernel` and :280 `_fwd_lean_nomax_kernel` (called through
// `_fused_lean_call`). For N [rows, D] (already scaled by 1/tau) and C
// [cols, D], both bf16, with f32 accumulation:
//
//   row_lse[i] = log sum_j exp(S[i, j])      col_lse[j] = log sum_i exp(S[i, j])
//
// "nomax" skips the max shift: the caller proves |S| <= 60 (unit-norm towers,
// 1/tau <= 60), so exp cannot overflow f32. Otherwise the row and column
// states are (max, sum of exp) pairs merged online.
//
// Design. The TPU kept all of C in VMEM and carried the column sums in
// scratch across a sequential grid of row blocks. On Hopper blocks run in
// parallel, so:
//   - each block owns 64 rows (4 warps x 16 rows) and walks every 64-column
//     tile of C, each in 128-deep chunks double-buffered in shared memory
//     with cp.async; a warp keeps its rows' bf16 A fragments of one chunk in
//     registers (at D = 128 loaded once, above it reloaded per chunk from
//     L1/L2), so registers and shared memory are the same at every D;
//   - S tiles come from mma.sync m16n8k16 (bf16 in, f32 out) and live only
//     in registers; each lane carries its rows' running sums over its
//     columns, merged across the 4 lanes of a row at the end;
//   - each block writes its column partials (sum of exp, and the max in the
//     shifted form) over its 64 rows to a [rows/64, cols] workspace, and a
//     second small kernel reduces them in a fixed order: no atomics, so two
//     calls give the same bits.
//
// Bound: at B = 8192, D = 128 the products are 2 B^2 D = 17.2 GFLOP, 0.017 ms
// at the 989 TFLOP/s bf16 peak; the bytes (N, C in, two lse vectors out) are
// 4.3 MB. It is bound by operations - and, below the tensor cores, by the
// B^2 = 67M exponentials on the special-function units (two per element in
// the shifted form), which this simple kernel does not hide.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing (the caller passes the
// workspace), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

constexpr int kBM = 64;            // rows per block
constexpr int kBN = 64;            // columns per tile of C
constexpr int kWarps = kBM / 16;   // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNSub = kBN / 8;     // 8-column mma tiles per column tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's -inf stand-in
constexpr unsigned kFull = 0xffffffffu;

// Chunk q of the kBN-row column tile j of c [cols, d] into shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* c, int j, int q,
                                          int d, int tid) {
  load_chunk_async<kBN, kThreads>(dst, c + static_cast<int64_t>(j) * kBN * d + q * kChunk, d, tid);
}

// kOneChunk: D = 128, the chunk loop compiled away
template <bool kNoMax, bool kOneChunk>
__global__ void __launch_bounds__(kThreads)
lean_lse_kernel(const __nv_bfloat16* __restrict__ n, const __nv_bfloat16* __restrict__ c,
                float* __restrict__ row_lse, float* __restrict__ part_max,
                float* __restrict__ part_sum, int cols, int d) {
  __shared__ __align__(16) __nv_bfloat16 tile[2][kBN * kChunkLd];
  __shared__ float col_red[kWarps][kBN];
  __shared__ float col_max[kBN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kBM + warp * 16 + g;  // this lane's rows: ra and ra + 8

  // at D = 128 the row stride is a constant, as the address arithmetic was before chunking
  if (kOneChunk) d = kChunk;
  const int n_chunks = kOneChunk ? 1 : d / kChunk;
  uint32_t a[kChunkSteps][4];
  load_row_fragments(a, n, ra, t, d, 0);

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
    if (n_chunks > 1) load_row_fragments(a, n, ra, t, d, q * kChunk);
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
__global__ void col_lse_kernel(const float* __restrict__ part_max,
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
int launch(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace, int rows,
           int cols, int d, cudaStream_t stream) {
  const int n_blocks = rows / kBM;
  float* part_sum = static_cast<float*>(workspace);
  float* part_max = part_sum + static_cast<int64_t>(n_blocks) * cols;
  auto kernel = d == kChunk ? lean_lse_kernel<kNoMax, true> : lean_lse_kernel<kNoMax, false>;
  kernel<<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(n), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(row_lse), part_max, part_sum, cols, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  col_lse_kernel<kNoMax><<<(cols + 255) / 256, 256, 0, stream>>>(
      part_max, part_sum, static_cast<float*>(col_lse), n_blocks, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n [rows, d] bf16 (scaled by 1/tau), c [cols, d] bf16, row_lse [rows]
// f32, col_lse [cols] f32, workspace 2 * (rows / 64) * cols f32; d a
// multiple of 128, rows and cols multiples of 64, all pointers 16-byte
// aligned (the wrapper checks).
int fused_lean_lse(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace,
                   int rows, int cols, int d, int nomax, void* stream) {
  if (d <= 0 || d % kChunk || rows % kBM || cols % kBN || rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return nomax ? launch<true>(n, c, row_lse, col_lse, workspace, rows, cols, d, s)
               : launch<false>(n, c, row_lse, col_lse, workspace, rows, cols, d, s);
}

const char* fused_lean_lse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
