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
// Design (D <= 512). The work is cut into units (a block of W NW columns of
// C against a 64-row tile of N); the units, block by block, are split evenly
// over a grid of 132 CTAs (one per SM of an H100; fewer when there are fewer
// units), so every SM gets the same number of tiles, and a CTA's range
// enters a new block a few times. A CTA has W consumer warpgroups and a
// producer warpgroup, which hands its registers to the consumers
// (setmaxnreg: 40 a thread for it, the rest for them):
//   - the column block is the resident operand: one producer thread loads it
//     by TMA ([64, 64] boxes, 128-byte swizzle) when the range enters the
//     block, and streams the row tiles of N through a ring of box stages
//     with mbarriers; each consumer warp releases a stage once its
//     products have completed;
//   - each consumer warpgroup holds NW of the block's columns and forms its
//     [64, NW] S tile with wgmma m64nNWk16, the streamed tile as A and its
//     columns as B, both K-major from shared memory; the first step
//     overwrites the accumulators (scale-d 0), so ptxas does not serialize
//     the wgmma. NW = 128 for the unshifted form up to D = 256; 64 past it
//     (the block would not fit beside the ring) and in the shifted form (its
//     column maxima and sums beside a 128-wide S spill at 168 registers);
//   - W = 3 for the unshifted form at D = 128 and the shifted form up to
//     D = 256, else 2 (shared memory): more warps to hide each one's waits;
//   - the warpgroups take turns (named barriers, round robin): one issues
//     its products once the one before it has its S, so the tensor cores
//     run one warpgroup's products while the others' exponentials run;
//   - reduce on the cheap side: in the accumulator layout a thread holds 2
//     rows of the tile and NW / 4 columns, the same columns for every tile.
//     A tile's row sums take 2 shuffles a row (over the 4 lanes of a row)
//     and go out as one partial per (row, NW-column block); the column sums
//     stay in registers, a running sum per thread and column over every
//     tile of the range in the block, and are reduced over lanes and warps
//     once, when the range leaves the block;
//   - exp is ex2.approx.ftz of S log2 e (one multiply, one special-function
//     op); the states are kept in log2 units;
//   - shifted form: a tile's row max comes with its row sums (2 shuffles);
//     a column's running max moves only when a value exceeds it by more
//     than 2^8, and then its running sum is rescaled (a vote per tile skips
//     the rescale when no column of the warp needs it), so a term stays
//     below 2^8, far from overflow, and an element takes one exponential
//     per side;
//   - a second small kernel merges the partials in a fixed order (rows: by
//     column block; columns: by CTA), so there are no atomics and two calls
//     give the same bits; it is launched as a programmatic dependent of the
//     sweep, so its launch overlaps the sweep's tail.
// Shared memory: the resident block (48 to 128 KB), the ring (up to 16 box
// stages) and the column-reduction scratch; one CTA per SM.
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

#include <type_traits>

#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tile_mma;

constexpr float kNegInf = -1e30f;  // the TPU kernel's -inf stand-in
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// -- D <= 512: warpgroups, wgmma and TMA ----------------------------------------

constexpr int kBox = 64;                    // a TMA box and a swizzle block: [64 rows, 64 bf16]
constexpr int kBoxBytes = kBox * kBox * 2;  // 8 KB, 1024-aligned in shared memory
constexpr int kSmemMax = 232448;            // shared memory a block can use
constexpr int kBarrierBytes = 512;
constexpr int kMaxStages = 16;
constexpr float kRescale = 8.f;  // log2 units a column's max may lag its values
constexpr int kTurn = 1;         // named barriers kTurn + w: consumer warpgroup w may issue its products
constexpr int kRed = 5;          // named barriers kRed + w: consumer warpgroup w's column reduction

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool kNoMax>
struct Plan {
  // columns a consumer warpgroup holds: 128 for the unshifted form up to
  // D = 256; 64 past it, where the block would not fit beside the ring, and
  // in the shifted form, whose column state would spill beside a 128-wide S
  static constexpr int kNW = kNoMax && D <= 256 ? 128 : 64;
  // consumer warpgroups, then one producer warpgroup: three where the shared
  // memory allows (they leave 152 registers a thread), else two
  static constexpr int kConsumers = (kNoMax && D == 128) || (!kNoMax && D <= 256) ? 3 : 2;
  static constexpr int kBlockCols = kConsumers * kNW;
  static constexpr int kColBoxes = kBlockCols / kBox;
  static constexpr int kDepthBoxes = D / kBox;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  // registers a thread: 40 for the producer, the rest of the SM's 65,536 for the consumers
  static constexpr int kConsumerRegs = (65536 / 128 - 40) / kConsumers / 8 * 8;
  static constexpr int kResBytes = kBlockCols * D * 2;
  static constexpr int kRedBytes = kConsumers * 4 * kNW * 8;  // a float2 per warpgroup, warp and column
  static constexpr int kFixed = 1024 + kResBytes + kRedBytes + kBarrierBytes;  // 1024: alignment slack
  static constexpr int kFit = (kSmemMax - kFixed) / kBoxBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kFixed + kStages * kBoxBytes;
  static_assert(D % 128 == 0 && D <= 512 && kStages > kDepthBoxes, "the wgmma path takes D = 128, 256, 384, 512");
};

// The split: unit u = x n_y + y is column block x against row tile y; CTA k
// takes units [k units / ctas, (k + 1) units / ctas).
struct Work {
  int rows, cols;
  int n_y;        // 64-row tiles of N
  int64_t units;  // column blocks x n_y
  int ctas;
};

// The CTA whose range holds unit u.
__device__ __forceinline__ int cta_of_unit(int64_t u, const Work& w) {
  return static_cast<int>(((u + 1) * w.ctas - 1) / w.units);
}

template <int D, bool kNoMax>
__global__ void __launch_bounds__(Plan<D, kNoMax>::kThreads, 1)
lean_lse_wgmma(const __grid_constant__ CUtensorMap map_n, const __grid_constant__ CUtensorMap map_c,
               float* __restrict__ ws_row, float* __restrict__ ws_col, Work w) {
  using P = Plan<D, kNoMax>;
  constexpr int kNW = P::kNW, kS = kNW / 2, kC = kNW / 4, kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res = smem;                                                    // [kDepthBoxes][kColBoxes] boxes
  uint8_t* ring = res + P::kResBytes;                                     // kStages boxes
  auto* red = reinterpret_cast<float2*>(ring + kStages * kBoxBytes);     // [kConsumers][4][kNW]
  auto* bars = reinterpret_cast<uint64_t*>(red + P::kConsumers * 4 * kNW);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* res_full = bars + 2 * kStages;
  uint64_t* res_empty = res_full + 1;

  // this CTA's units (fewer than 2^31: the wrapper's shapes give at most 2^19)
  const int u0 = static_cast<int>(blockIdx.x * w.units / w.ctas);
  const int u1 = static_cast<int>((blockIdx.x + 1) * w.units / w.ctas);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], 4 * P::kConsumers);  // one arrival per consumer warp
    }
    wgmma::mbar_init(res_full, 1);
    wgmma::mbar_init(res_empty, 4 * P::kConsumers);
    wgmma::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == P::kConsumers) {  // the producer warpgroup: one thread issues every copy
    wgmma::setmaxnreg_dec<40>();
    if (threadIdx.x == P::kConsumers * 128) {
      int x = static_cast<int>(u0 / w.n_y), y = static_cast<int>(u0 % w.n_y);
      uint32_t res_phase = 0;
      int stage = 0;
      uint32_t phase = 0;    // of the ring's current pass
      bool wrapped = false;  // past the first pass: a stage's last fill must have been read
      for (int u = u0; u < u1; ++u) {
        if (u == u0 || y == 0) {  // a new column block, once the consumers are done with the last
          if (u > u0) {
            wgmma::mbar_wait(res_empty, res_phase);
            res_phase ^= 1;
          }
          const int col0 = x * P::kBlockCols;
          const int left = (w.cols - col0) / kBox;
          const int present = left < P::kColBoxes ? left : P::kColBoxes;  // boxes past cols are not loaded
          wgmma::mbar_expect_tx(res_full, present * P::kDepthBoxes * kBoxBytes);
          for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
            for (int h = 0; h < present; ++h) {
              wgmma::tma_load_2d(res + (kb * P::kColBoxes + h) * kBoxBytes, &map_c, kb * kBox, col0 + h * kBox,
                                 res_full);
            }
          }
        }
        for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
          if (wrapped) wgmma::mbar_wait(&empty[stage], phase ^ 1);
          wgmma::mbar_expect_tx(&full[stage], kBoxBytes);
          wgmma::tma_load_2d(ring + stage * kBoxBytes, &map_n, kb * kBox, y * kBox, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
            wrapped = true;
          }
        }
        if (++y == w.n_y) {
          y = 0;
          ++x;
        }
      }
    }
    return;
  }

  wgmma::setmaxnreg_inc<P::kConsumerRegs>();
  const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t res_base = wgmma::smem_u32(res) + wg * (kNW / kBox) * kBoxBytes;
  const uint32_t ring_base = wgmma::smem_u32(ring);
  float2* my_red = red + wg * 4 * kNW;
  // the warpgroups issue in turn, 0 first: warpgroup w waits on barrier
  // kTurn + w, which the one before it signals
  const int next_turn = kTurn + (wg + 1) % P::kConsumers;
  if (wg == P::kConsumers - 1) wgmma::named_barrier_arrive(kTurn, 256);

  // The S tile: s[4i + e] is row 16 warp + g, column 8i + 2t + e of this
  // warpgroup's columns, s[4i + 2 + e] the same column of row + 8.
  float s[kS];
  // Column state of this thread over its rows of every tile so far: cs[2i + e]
  // the sum of exp (shifted: of exp2(S log2 e - cm)), cm the max in log2 units.
  float cs[kC], cm[kC];
  int col0 = 0, valid = 0;

  // The column partials of the block this range leaves: over the 8 lanes of a
  // column (xor 4, 8, 16), then the 4 warps in order, one per CTA and column.
  auto flush = [&](int x) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        if constexpr (kNoMax) {
          cs[c] += __shfl_xor_sync(kFull, cs[c], off);
        } else {
          const float om = __shfl_xor_sync(kFull, cm[c], off), os = __shfl_xor_sync(kFull, cs[c], off);
          const float m = fmaxf(cm[c], om);
          cs[c] = cs[c] * exp2_approx(cm[c] - m) + os * exp2_approx(om - m);
          cm[c] = m;
        }
      }
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) my_red[warp * kNW + 8 * i + 2 * t + e] = make_float2(cs[2 * i + e], cm[2 * i + e]);
      }
    }
    wgmma::named_barrier_sync(kRed + wg, 128);
    if (wt < valid) {
      const int p = blockIdx.x - cta_of_unit(static_cast<int64_t>(x) * w.n_y, w);  // this CTA's piece
      const int64_t o = static_cast<int64_t>(p) * w.cols + col0 + wt;
      const float2 a = my_red[wt], b = my_red[kNW + wt], c = my_red[2 * kNW + wt], d = my_red[3 * kNW + wt];
      if constexpr (kNoMax) {
        ws_col[o] = (a.x + b.x) + (c.x + d.x);
      } else {
        const float m = fmaxf(fmaxf(a.y, b.y), fmaxf(c.y, d.y));
        const float sum = (a.x * exp2_approx(a.y - m) + b.x * exp2_approx(b.y - m)) +
                          (c.x * exp2_approx(c.y - m) + d.x * exp2_approx(d.y - m));
        reinterpret_cast<float2*>(ws_col)[o] = make_float2(sum, m);
      }
    }
    wgmma::named_barrier_sync(kRed + wg, 128);  // the scratch is reused at the next block
  };

  // This tile's row partials over the warpgroup's columns (only the first
  // `valid` when kMasked), and its share of the column state.
  auto epilogue = [&](auto masked, int y) {
    constexpr bool kMasked = decltype(masked)::value;
    const int r0 = y * kBox + warp * 16 + g;
    const int64_t o = static_cast<int64_t>(col0 / kNW) * w.rows + r0;
    float ra[2] = {0.f, 0.f};  // this lane's share of its two rows' sums
    if constexpr (kNoMax) {
      float rb[2] = {0.f, 0.f};  // a second chain a row: ra over even i, rb over odd i
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
        if (kMasked && 8 * i >= valid) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = exp2_approx(s[4 * i + e] * kLog2e), b = exp2_approx(s[4 * i + 2 + e] * kLog2e);
          if (i & 1) {
            rb[0] += a;
            rb[1] += b;
          } else {
            ra[0] += a;
            ra[1] += b;
          }
          cs[2 * i + e] += a + b;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ra[r] += rb[r];
        ra[r] += __shfl_xor_sync(kFull, ra[r], 1);
        ra[r] += __shfl_xor_sync(kFull, ra[r], 2);
      }
      if (t == 0) {
        ws_row[o] = ra[0];
        ws_row[o + 8] = ra[1];
      }
    } else {
      float m[2] = {kNegInf, kNegInf};
      bool need = false;
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
        if (kMasked && 8 * i >= valid) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * i + e] *= kLog2e;
          s[4 * i + 2 + e] *= kLog2e;
          m[0] = fmaxf(m[0], s[4 * i + e]);
          m[1] = fmaxf(m[1], s[4 * i + 2 + e]);
          need |= fmaxf(s[4 * i + e], s[4 * i + 2 + e]) > cm[2 * i + e] + kRescale;
        }
      }
      if (__any_sync(kFull, need)) {  // some column's max moves: rescale its sum
#pragma unroll
        for (int i = 0; i < kNW / 8; ++i) {
          if (kMasked && 8 * i >= valid) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = fmaxf(s[4 * i + e], s[4 * i + 2 + e]);
            const float nm = v > cm[2 * i + e] + kRescale ? v : cm[2 * i + e];
            cs[2 * i + e] *= exp2_approx(cm[2 * i + e] - nm);
            cm[2 * i + e] = nm;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
      }
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
        if (kMasked && 8 * i >= valid) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = s[4 * i + e], b = s[4 * i + 2 + e];
          ra[0] += exp2_approx(a - m[0]);
          ra[1] += exp2_approx(b - m[1]);
          cs[2 * i + e] += exp2_approx(a - cm[2 * i + e]) + exp2_approx(b - cm[2 * i + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ra[r] += __shfl_xor_sync(kFull, ra[r], 1);
        ra[r] += __shfl_xor_sync(kFull, ra[r], 2);
      }
      if (t == 0) {
        auto* row2 = reinterpret_cast<float2*>(ws_row);
        row2[o] = make_float2(ra[0], m[0]);
        row2[o + 8] = make_float2(ra[1], m[1]);
      }
    }
  };

  int x = static_cast<int>(u0 / w.n_y), y = static_cast<int>(u0 % w.n_y), stage = 0;
  uint32_t phase = 0, res_phase = 0;
  for (int u = u0; u < u1; ++u) {
    if (u == u0 || y == 0) {  // a new column block
      col0 = x * P::kBlockCols + wg * kNW;
      valid = w.cols - col0 < 0 ? 0 : (w.cols - col0 < kNW ? w.cols - col0 : kNW);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        cs[c] = 0.f;
        cm[c] = kNegInf;
      }
      wgmma::mbar_wait(res_full, res_phase);
      res_phase ^= 1;
    }
    // this unit's boxes: stages stage0 .. stage0 + kDepthBoxes - 1, wrapping
    const int stage0 = stage;
#pragma unroll
    for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
      wgmma::mbar_wait(&full[stage], phase);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma::named_barrier_sync(kTurn + wg, 256);
    wgmma::fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int sk = stage0 + k / 4 < kStages ? stage0 + k / 4 : stage0 + k / 4 - kStages;
      const uint64_t a = wgmma::desc_sw128(ring_base + sk * kBoxBytes + (k % 4) * 32, 16, 1024);
      const uint64_t b = wgmma::desc_sw128(res_base + (k / 4) * P::kColBoxes * kBoxBytes + (k % 4) * 32, 16, 1024);
      if constexpr (kNW == 128) {
        if (k == 0) {
          wgmma::mma_ss_first_m64n128k16<0>(s, a, b);
        } else {
          wgmma::mma_ss_m64n128k16<0>(s, a, b, 1);
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
    wgmma::wait<0>();
    wgmma::fence_operand(s);
    // the next warpgroup's turn, once this one's products are done, so its
    // products run while this one's exponentials do (the last warpgroup's
    // last arrival would go unmatched)
    if (wg < P::kConsumers - 1 || u + 1 < u1) wgmma::named_barrier_arrive(next_turn, 256);
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int kb = 0; kb < P::kDepthBoxes; ++kb) {
        wgmma::mbar_arrive(&empty[stage0 + kb < kStages ? stage0 + kb : stage0 + kb - kStages]);
      }
    }
    if (valid == kNW) {
      epilogue(std::false_type{}, y);
    } else if (valid > 0) {
      epilogue(std::true_type{}, y);
    }
    if (++y == w.n_y) {  // the range leaves block x: its column partials, and its buffer back
      y = 0;
      flush(x++);
      __syncwarp();
      if (lane == 0) wgmma::mbar_arrive(res_empty);
    }
  }
  if (y != 0) flush(x);  // the range ends inside block x
}

// row_lse and col_lse from the partials, each merged in a fixed order: a row
// over its NW-column blocks, a column over the CTAs whose ranges cover its
// block.
template <bool kNoMax>
__global__ void lean_merge(const float* __restrict__ ws_row, const float* __restrict__ ws_col,
                           float* __restrict__ row_lse, float* __restrict__ col_lse, Work w, int row_parts,
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
    const int64_t u = static_cast<int64_t>(j / block_cols) * w.n_y;
    base = ws_col + (kNoMax ? j : 2 * j);
    stride = w.cols;
    parts = cta_of_unit(u + w.n_y - 1, w) - cta_of_unit(u, w) + 1;
    out = col_lse + j;
  } else {
    return;
  }
  if constexpr (kNoMax) {
    float sum = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) sum += base[p * stride];
    *out = kLn2 * log2f(sum);
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
    *out = kLn2 * (m + log2f(sum));
  }
}

template <int D, bool kNoMax>
cudaError_t launch_wgmma(const void* n, const void* c, void* row_lse, void* col_lse, void* workspace, int rows,
                         int cols, int ctas, cudaStream_t stream) {
  using P = Plan<D, kNoMax>;
  const int n_x = (cols + P::kBlockCols - 1) / P::kBlockCols;
  const Work w{rows, cols, rows / kBox, static_cast<int64_t>(n_x) * (rows / kBox), ctas};
  if (ctas <= 0 || ctas > w.units || w.units >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int row_parts = (cols + P::kNW - 1) / P::kNW;
  CUtensorMap map_n, map_c;
  cudaError_t err = wgmma::box_map(&map_n, n, rows, D);
  if (err == cudaSuccess) err = wgmma::box_map(&map_c, c, cols, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lean_lse_wgmma<D, kNoMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  float* ws_row = static_cast<float*>(workspace);  // [row_parts][rows], a float2 each when shifted
  float* ws_col = ws_row + 2 * static_cast<int64_t>(row_parts) * rows;  // [pieces][cols], likewise
  lean_lse_wgmma<D, kNoMax><<<ctas, P::kThreads, P::kSmemBytes, stream>>>(map_n, map_c, ws_row, ws_col, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + cols + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lean_merge<kNoMax>, static_cast<const float*>(ws_row),
                            static_cast<const float*>(ws_col), static_cast<float*>(row_lse),
                            static_cast<float*>(col_lse), w, row_parts, P::kBlockCols);
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
    case 128: return nomax ? Plan<128, true>::kSmemBytes : Plan<128, false>::kSmemBytes;
    case 256: return nomax ? Plan<256, true>::kSmemBytes : Plan<256, false>::kSmemBytes;
    case 384: return nomax ? Plan<384, true>::kSmemBytes : Plan<384, false>::kSmemBytes;
    case 512: return nomax ? Plan<512, true>::kSmemBytes : Plan<512, false>::kSmemBytes;
    default: return 0;
  }
}

const char* fused_lean_lse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
