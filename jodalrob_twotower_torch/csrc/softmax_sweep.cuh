// The warpgroup sweep over S = N C^T (Hopper, sm_90a) that the lean CE
// forward (fused_ce_fwd.cu) and the statistics sweep (fused_stats.cu) share,
// up to D = 512: the split of the work over the SMs, the producer that
// streams N and holds a block of C, the wgmma that forms S, the softmax
// states and the fixed-order partials. kStats adds, per element, a plain row
// and column sum and the rank comparison against the row's diagonal.
//
// The work is cut into units (a block of W NW columns of C against a 64-row
// tile of N); the units, block by block, are split evenly over a grid of at
// most 132 CTAs (one per SM of an H100), so every SM gets the same number of
// tiles, and a CTA's range enters a new block a few times. A CTA has W
// consumer warpgroups and a producer warpgroup, which hands its registers to
// the consumers (setmaxnreg: 40 a thread for it, the rest for them; ptxas
// still compiles every thread for the block's share, 128 registers with
// three consumers, 168 with two):
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
//     (the block would not fit beside the ring), in the shifted form (its
//     column maxima and sums beside a 128-wide S spill at 168 registers) and
//     for the statistics (shifted, with plain column sums besides);
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
//   - statistics: the plain sums and the rank comparison read S before it is
//     scaled to log2 units; each thread loads its two rows' diagonal values
//     while its products run; the diagonal's own column (column row +
//     row_offset) is left out of rank by index, never by value;
//   - a second small kernel (in each source) merges the partials in a fixed
//     order (rows: by column block; columns: by CTA), so there are no atomics
//     and two calls give the same bits; it is launched as a programmatic
//     dependent of the sweep (launch_dependent), so its launch overlaps the
//     sweep's tail.
// Shared memory: the resident block (48 to 128 KB), the ring (up to 16 box
// stages) and the column-reduction scratch; one CTA per SM.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace softmax_sweep {

constexpr float kNegInf = -1e30f;  // the TPU kernels' -inf stand-in
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

template <int D, bool kNoMax, bool kStats = false>
struct Plan {
  static_assert(!(kNoMax && kStats), "the statistics take the shifted form");
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
  // a float2 (sum, max) per warpgroup, warp and column; a float4 (and the plain sum) for the statistics
  static constexpr int kRedBytes = kConsumers * 4 * kNW * (kStats ? 16 : 8);
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

// The partials a column of block x merges: one per CTA whose range meets the block.
__device__ __forceinline__ int col_parts_of_block(int x, const Work& w) {
  const int64_t u = static_cast<int64_t>(x) * w.n_y;
  return cta_of_unit(u + w.n_y - 1, w) - cta_of_unit(u, w) + 1;
}

// The sweep. Partials, each a float2 (sum, max) when shifted, a float when
// not, a float4 (sum of exp2, max, plain sum, rank) for the statistics:
// ws_row [ceil(cols / NW)][rows], by column block of NW; ws_col
// [pieces][cols], piece p of a column coming from the p-th CTA whose range
// meets its block. diag and row_offset: the statistics' diagonal (diag[i] =
// S[i, i + row_offset]), unread otherwise.
template <int D, bool kNoMax, bool kStats>
__global__ void __launch_bounds__(Plan<D, kNoMax, kStats>::kThreads, 1)
sweep_wgmma(const __grid_constant__ CUtensorMap map_n, const __grid_constant__ CUtensorMap map_c,
            float* __restrict__ ws_row, float* __restrict__ ws_col, Work w, const float* __restrict__ diag,
            int row_offset) {
  using P = Plan<D, kNoMax, kStats>;
  using Red = std::conditional_t<kStats, float4, float2>;
  constexpr int kNW = P::kNW, kS = kNW / 2, kC = kNW / 4, kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res = smem;                                                 // [kDepthBoxes][kColBoxes] boxes
  uint8_t* ring = res + P::kResBytes;                                  // kStages boxes
  auto* red = reinterpret_cast<Red*>(ring + kStages * kBoxBytes);     // [kConsumers][4][kNW]
  auto* bars = reinterpret_cast<uint64_t*>(red + P::kConsumers * 4 * kNW);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* res_full = bars + 2 * kStages;
  uint64_t* res_empty = res_full + 1;

  // this CTA's units (fewer than 2^31: the wrappers' shapes give at most 2^19)
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
  Red* my_red = red + wg * 4 * kNW;
  // the warpgroups issue in turn, 0 first: warpgroup w waits on barrier
  // kTurn + w, which the one before it signals
  const int next_turn = kTurn + (wg + 1) % P::kConsumers;
  if (wg == P::kConsumers - 1) wgmma::named_barrier_arrive(kTurn, 256);

  // The S tile: s[4i + e] is row 16 warp + g, column 8i + 2t + e of this
  // warpgroup's columns, s[4i + 2 + e] the same column of row + 8.
  float s[kS];
  // Column state of this thread over its rows of every tile so far: cs[2i + e]
  // the sum of exp (shifted: of exp2(S log2 e - cm)), cm the max in log2
  // units; ps the plain sum (statistics).
  float cs[kC], cm[kC], ps[kStats ? kC : 1];
  float dg[2] = {0.f, 0.f};  // the diagonal of this thread's two rows of the tile (statistics)
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
        if constexpr (kStats) ps[c] += __shfl_xor_sync(kFull, ps[c], off);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < kNW / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * i + e;
          if constexpr (kStats) {
            my_red[warp * kNW + 8 * i + 2 * t + e] = make_float4(cs[c], cm[c], ps[c], 0.f);
          } else {
            my_red[warp * kNW + 8 * i + 2 * t + e] = make_float2(cs[c], cm[c]);
          }
        }
      }
    }
    wgmma::named_barrier_sync(kRed + wg, 128);
    if (wt < valid) {
      const int p = blockIdx.x - cta_of_unit(static_cast<int64_t>(x) * w.n_y, w);  // this CTA's piece
      const int64_t o = static_cast<int64_t>(p) * w.cols + col0 + wt;
      const Red a = my_red[wt], b = my_red[kNW + wt], c = my_red[2 * kNW + wt], d = my_red[3 * kNW + wt];
      if constexpr (kNoMax) {
        ws_col[o] = (a.x + b.x) + (c.x + d.x);
      } else {
        const float m = fmaxf(fmaxf(a.y, b.y), fmaxf(c.y, d.y));
        const float sum = (a.x * exp2_approx(a.y - m) + b.x * exp2_approx(b.y - m)) +
                          (c.x * exp2_approx(c.y - m) + d.x * exp2_approx(d.y - m));
        if constexpr (kStats) {
          reinterpret_cast<float4*>(ws_col)[o] = make_float4(sum, m, (a.z + b.z) + (c.z + d.z), 0.f);
        } else {
          reinterpret_cast<float2*>(ws_col)[o] = make_float2(sum, m);
        }
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
      // statistics: the plain sums and the entries above the diagonal, from S
      // as formed (the diagonal's own column, local column dc of row r0 and
      // dc + 8 of row r0 + 8, left out by index)
      if constexpr (kStats) {
        float rs[2] = {0.f, 0.f};
        int rk[2] = {0, 0};
        const int dc = r0 + row_offset - col0;
#pragma unroll
        for (int i = 0; i < kNW / 8; ++i) {
          if (kMasked && 8 * i >= valid) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * t + e;
            const float a = s[4 * i + e], b = s[4 * i + 2 + e];
            rs[0] += a;
            rs[1] += b;
            ps[2 * i + e] += a + b;
            rk[0] += (a > dg[0] && col != dc) ? 1 : 0;
            rk[1] += (b > dg[1] && col != dc + 8) ? 1 : 0;
          }
        }
        // out now, the (plain sum, rank) half of each row's float4, so
        // they hold no registers through the exponentials
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
          rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
          rk[r] += __shfl_xor_sync(kFull, rk[r], 1);
          rk[r] += __shfl_xor_sync(kFull, rk[r], 2);
        }
        if (t == 0) {
          auto* row2 = reinterpret_cast<float2*>(ws_row);
          row2[2 * o + 1] = make_float2(rs[0], static_cast<float>(rk[0]));
          row2[2 * (o + 8) + 1] = make_float2(rs[1], static_cast<float>(rk[1]));
        }
      }
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
      if (t == 0) {  // the (sum, max) pair; the statistics' float4 takes it as its first half
        auto* row2 = reinterpret_cast<float2*>(ws_row);
        const int64_t at = kStats ? 2 * o : o;
        row2[at] = make_float2(ra[0], m[0]);
        row2[at + (kStats ? 16 : 8)] = make_float2(ra[1], m[1]);
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
        if constexpr (kStats) ps[c] = 0.f;
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
    if constexpr (kStats) {  // loaded while the products run
      const int r0 = y * kBox + warp * 16 + g;
      dg[0] = __ldg(diag + r0);
      dg[1] = __ldg(diag + r0 + 8);
    }
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

// Launches the sweep for N [rows, D] against C [cols, D] on `ctas` CTAs
// (at most the units), partials into ws_row and ws_col; the grid and the
// workspace come from the wrappers' launch shapes.
template <int D, bool kNoMax, bool kStats>
cudaError_t launch_sweep(const void* n, const void* c, float* ws_row, float* ws_col, Work* w, int rows,
                         int cols, int ctas, const float* diag, int row_offset, cudaStream_t stream) {
  using P = Plan<D, kNoMax, kStats>;
  const int n_x = (cols + P::kBlockCols - 1) / P::kBlockCols;
  *w = Work{rows, cols, rows / kBox, static_cast<int64_t>(n_x) * (rows / kBox), ctas};
  if (ctas <= 0 || ctas > w->units || w->units >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  CUtensorMap map_n, map_c;
  cudaError_t err = wgmma::box_map(&map_n, n, rows, D);
  if (err == cudaSuccess) err = wgmma::box_map(&map_c, c, cols, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(sweep_wgmma<D, kNoMax, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  sweep_wgmma<D, kNoMax, kStats><<<ctas, P::kThreads, P::kSmemBytes, stream>>>(map_n, map_c, ws_row, ws_col, *w,
                                                                               diag, row_offset);
  return cudaGetLastError();
}

// Launches `kernel` on `blocks` x 256 threads behind the kernel before it on
// the stream, with programmatic stream serialization: its launch overlaps
// that kernel's tail, and the kernel waits (griddepcontrol.wait) for its
// writes before reading them.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int blocks, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace softmax_sweep
