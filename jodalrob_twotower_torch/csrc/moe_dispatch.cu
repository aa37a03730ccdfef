// Expert dispatch of a mixture-of-experts layer for Hopper (sm_90a): the
// sort of the (token, expert) pairs by expert, and the two grouped expert
// products of ops/moe.py (the combine stays a Triton pass there).
//
// Replaces no TPU kernel: the text encoder (models/text_encoder.py,
// kanana-2-30b-a3b's 47 MoE layers of 128 experts, top 6) is new to the
// port, and no kernel of it groups rows by expert.
//
// A layer of T tokens routed to k experts has P = T k pairs; pair p is token
// p / k's choice p % k, and a pair whose expert id is E (one past the last)
// is dropped (its token is padding).
//
// moe_sort_pairs. A stable counting sort of the pairs' expert ids, with no
// host sync: counts [E + 1], offsets [E + 1] (each bucket's first sorted
// row), perm (sorted row -> pair) and inv (pair -> sorted row), and, where a
// tally is given, each expert's pairs and one (if it got any) added to it.
// Bound: bytes, a few hundred kB a layer, so launches and latency dominate;
// and perm's writes scatter, 4 bytes each, which one SM issues slowly (a
// one-CTA sort read 76 us at 49,152 pairs). Design: two launches of up to
// 128 CTAs of 32 warps, each CTA a contiguous segment of the pairs and each
// warp a contiguous part of it. Each warp counts its part's ids per bucket
// into its own row of shared memory (nine ballots over the id's bits find
// the lanes of a load of 32 holding the same id; the group's first lane adds
// its size; no atomics). The first launch writes each CTA's counts. The
// second counts again, sums the CTAs' counts into each bucket's first row
// and each CTA's and warp's first row in it, then each warp walks its part
// in order and places each pair at its bucket's next row (its rank among
// equal ids in the load, then the group's leader advances the row), so the
// sort is stable.
//
// moe_grouped_gate_up / moe_grouped_down. For each expert, its rows of the
// sorted order times its weights: gate/up h = silu(x W_g^T) * (x W_u^T),
// x each pair's token row (gathered by perm in the loads), W_g and W_u the
// expert's halves of w_gate_up [E, 2I, H]; down y = w (h W_d^T), W_d the
// expert's [H, I] and w the pair's routing weight. bf16 operands, f32 sums.
// Bound: at the encoder's widths (H 2048, I 768) and about 32,000 real pairs
// a layer, about 200 GFLOP (gate/up) against 0.8 GB of touched weights: the
// two bounds lie close, so the kernel has to keep both the tensor cores and
// the memory busy. Design: a CTA takes 128 rows of one expert (found from
// the counts on the card: tile m of the launch belongs to the expert whose
// cumulative tile count passes m, so the launch has ceil(P / 128) + E row
// tiles, and those past the last exit at once) and 256 weight rows (gate/up:
// 128 gate and the matching 128 up rows; down: 256 output columns). Two
// warpgroups each multiply 64 of the rows with wgmma (m64n128 twice, or
// m64n256), from a ring of 4 stages of 64-deep tiles in shared memory in
// the 128-byte swizzle: the weight tile by TMA (four [64, 64] boxes,
// completing on the stage's mbarrier), the activation rows by cp.async with
// the same swizzle written by hand (rows gathered through perm, those past
// the expert's end clamped to its last row and never stored). Loads run two
// stages ahead of the product. The epilogue applies silu(g) * u, or the
// routing weight, in f32 and stores bf16. Row tiles of one expert are
// neighbours in the launch, so they share its weights through L2.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- the sort --------------------------------------------------------------------

constexpr int kSortWarps = 32;
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kMaxBuckets = 257;  // at most 256 experts, and the drop bucket
constexpr int kSortUnroll = 2;    // loads of 32 ids a warp keeps in flight
constexpr int kMinPerCta = kSortThreads * kSortUnroll;  // pairs a CTA takes at least
constexpr int kMaxCtas = 128;     // the scatter's CTAs sum the counts of those before them
constexpr int kIdBits = 9;        // buckets and the sentinel below 2^9
constexpr int kNoPair = (1 << kIdBits) - 1;  // a lane past the segment's end

// pairs a CTA takes: a multiple of kMinPerCta, so that each warp's share is
// whole loads of 32, and few enough CTAs that each sums the others' counts cheaply
__host__ __device__ __forceinline__ int sort_per_cta(int n_pairs) {
  const int least = (n_pairs + kMaxCtas - 1) / kMaxCtas;
  return ((least + kMinPerCta - 1) / kMinPerCta) * kMinPerCta + (least == 0 ? kMinPerCta : 0);
}

// an id's bucket: ids outside [0, n_experts] go with the dropped pairs
__device__ __forceinline__ int bucket(int id, int n_experts) {
  return static_cast<unsigned>(id) > static_cast<unsigned>(n_experts) ? n_experts : id;
}

// the lanes of the warp whose id equals this lane's (every lane calls it)
__device__ __forceinline__ unsigned peers(int id) {
  unsigned same = kFull;
#pragma unroll
  for (int b = 0; b < kIdBits; ++b) {
    const unsigned ones = __ballot_sync(kFull, (id >> b) & 1);
    same &= ((id >> b) & 1) ? ones : ~ones;
  }
  return same;
}

// Both passes of the sort. Each CTA takes a contiguous segment of the pairs
// and each of its warps a contiguous part of that, and counts its part's ids
// per bucket into rows[warp]. The first pass writes the CTA's counts to
// cta_counts [CTAs][kMaxBuckets] and ends. The second sums them into each
// bucket's total and first sorted row (CTA 0 writes counts, offsets and the
// tally) and into this CTA's first row in each bucket, turns rows[warp] into
// each warp's first row, and places every pair in order.
template <bool kScatter>
__global__ void __launch_bounds__(kSortThreads, 1)
sort_pairs_kernel(const int* __restrict__ ids, int n_pairs, int n_experts, int per_cta,
                  int* __restrict__ cta_counts, int* __restrict__ perm, int* __restrict__ inv,
                  int* __restrict__ counts, int* __restrict__ offsets, long long* __restrict__ tally) {
  __shared__ int rows[kSortWarps][kMaxBuckets];  // a warp's count, then its next row, per bucket
  __shared__ int base[kMaxBuckets];
  const int nb = n_experts + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;
  for (int i = threadIdx.x; i < kSortWarps * kMaxBuckets; i += kSortThreads) (&rows[0][0])[i] = 0;
  __syncthreads();

  const int per_warp = per_cta / kSortWarps;
  const int seg0 = blockIdx.x * per_cta + warp * per_warp;
  const int seg1 = min(n_pairs, seg0 + per_warp);

  for (int at = seg0; at < seg1; at += 32 * kSortUnroll) {
    int id[kSortUnroll];
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u) {
      const int i = at + u * 32 + lane;
      id[u] = i < seg1 ? bucket(__ldg(ids + i), n_experts) : kNoPair;
    }
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u) {
      const unsigned same = peers(id[u]);
      if (id[u] != kNoPair && (same & below) == 0) rows[warp][id[u]] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();

  if (!kScatter) {
    if (threadIdx.x < nb) {
      int c = 0;
      for (int w = 0; w < kSortWarps; ++w) c += rows[w][threadIdx.x];
      cta_counts[blockIdx.x * kMaxBuckets + threadIdx.x] = c;
    }
    return;
  }

  // each bucket's total, and the earlier CTAs' share of it
  int before = 0;
  if (threadIdx.x < nb) {
    int total = 0;
    for (int g = 0; g < static_cast<int>(gridDim.x); ++g) {
      const int c = cta_counts[g * kMaxBuckets + threadIdx.x];
      total += c;
      before += g < static_cast<int>(blockIdx.x) ? c : 0;
    }
    base[threadIdx.x] = total;
  }
  __syncthreads();
  // the buckets' first rows (warp 0, 32 buckets a step)
  if (warp == 0) {
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int c = b < nb ? base[b] : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (b < nb) {
        base[b] = carry + incl - c;
        if (blockIdx.x == 0) {
          counts[b] = c;
          offsets[b] = carry + incl - c;
          if (tally != nullptr && b < n_experts) {
            tally[2 * b] += c;
            tally[2 * b + 1] += c > 0;
          }
        }
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
  // each warp's first row in each bucket: the bucket's first row, the
  // earlier CTAs' pairs in it and this CTA's earlier warps'
  if (threadIdx.x < nb) {
    int run = base[threadIdx.x] + before;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = rows[w][threadIdx.x];
      rows[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();

  // each pair to its bucket's next row, in pair order
  for (int at = seg0; at < seg1; at += 32 * kSortUnroll) {
    int id[kSortUnroll];
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u) {
      const int i = at + u * 32 + lane;
      id[u] = i < seg1 ? bucket(__ldg(ids + i), n_experts) : kNoPair;
    }
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u) {
      const unsigned same = peers(id[u]);
      if (id[u] != kNoPair) {
        const int row = rows[warp][id[u]] + __popc(same & below);
        const int i = at + u * 32 + lane;
        perm[row] = i;
        inv[i] = row;
      }
      __syncwarp();
      if (id[u] != kNoPair && (same & below) == 0) rows[warp][id[u]] += __popc(same);
      __syncwarp();
    }
  }
}

// -- the grouped products ---------------------------------------------------------

constexpr int kBM = 128;          // rows of one expert a tile
constexpr int kBK = 64;           // depth a stage: one 128-byte swizzled row
constexpr int kWRows = 256;       // weight rows a tile
constexpr int kStages = 4;
constexpr int kThreads = 256;     // two warpgroups of 64 rows
constexpr int kBoxBytes = 64 * kBK * 2;  // one [64, 64] bf16 box
constexpr int kABytes = kBM * kBK * 2;
constexpr int kWBytes = kWRows * kBK * 2;
constexpr int kStageBytes = kABytes + kWBytes;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStages * 8;

// (expert, first row, end row) of this CTA's row tile; expert -1 past the last tile
__device__ __forceinline__ void find_tile(const int* counts, const int* offsets, int n_experts, int* info) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) info[0] = -1;
  __syncwarp();
  int carry = 0;
  const int m = blockIdx.x;
  for (int e0 = 0; e0 < n_experts; e0 += 32) {
    const int e = e0 + lane;
    const int c = e < n_experts ? counts[e] : 0;
    const int tiles = (c + kBM - 1) / kBM;
    int incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int start = carry + incl - tiles;
    if (e < n_experts && m >= start && m < start + tiles) {
      const int off = offsets[e];
      info[0] = e;
      info[1] = off + (m - start) * kBM;
      info[2] = off + c;
    }
    carry += __shfl_sync(kFull, incl, 31);
    if (carry > m) break;  // uniform across the warp
  }
}

// kGateUp: a = x [T, depth] (rows gathered as perm[row] / top_k), weights
// [E, 2 n_out, depth], out h [P, n_out]. Otherwise a = h [P, depth] in
// sorted order, weights [E, n_out, depth], out y [P, n_out] scaled by
// route_w[perm[row]].
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 1)
grouped_product(const __nv_bfloat16* __restrict__ a, const __grid_constant__ CUtensorMap w_map,
                __nv_bfloat16* __restrict__ out, const int* __restrict__ perm, const float* __restrict__ route_w,
                const int* __restrict__ counts, const int* __restrict__ offsets, int n_experts, int depth,
                int n_out, int top_k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  auto* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  __shared__ int info[3];

  if (threadIdx.x < 32) find_tile(counts, offsets, n_experts, info);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) wgmma::mbar_init(&full[s], 1);
    wgmma::fence_barrier_init();
  }
  __syncthreads();
  const int expert = info[0];
  if (expert < 0) return;
  const int row0 = info[1], row_end = info[2];
  const int n0 = blockIdx.y * (kGateUp ? kWRows / 2 : kWRows);
  const int n_k = depth / kBK;

  // this thread's activation pieces: 16 bytes (piece p) of rows r = tid / 8 + 32 j
  const int piece = threadIdx.x % 8;
  const __nv_bfloat16* a_src[kBM * 8 / kThreads];
  uint32_t a_dst[kBM * 8 / kThreads];
#pragma unroll
  for (int j = 0; j < kBM * 8 / kThreads; ++j) {
    const int r = threadIdx.x / 8 + 32 * j;
    const int row = min(row0 + r, row_end - 1);
    const int src = kGateUp ? __ldg(perm + row) / top_k : row;
    a_src[j] = a + static_cast<int64_t>(src) * depth + piece * 8;
    a_dst[j] = r * 128 + ((piece ^ (r & 7)) << 4);
  }
  // the weight rows of this tile's four boxes
  int w_row[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w_row[q] = kGateUp ? expert * 2 * n_out + (q / 2) * n_out + n0 + (q % 2) * 64
                       : expert * n_out + n0 + q * 64;
  }

  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int j = 0; j < kBM * 8 / kThreads; ++j) {
      const uint32_t dst = wgmma::smem_u32(st) + a_dst[j];
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(a_src[j] + kt * kBK));
    }
    if (threadIdx.x == 0) {
      uint64_t* bar = &full[kt % kStages];
      wgmma::mbar_expect_tx(bar, kWBytes);
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma::tma_load_2d(st + kABytes + q * kBoxBytes, &w_map, kt * kBK, w_row[q], bar);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < n_k) load_stage(s);
    asm volatile("cp.async.commit_group;\n");
  }

  const int wg = threadIdx.x / 128;
  constexpr int kAcc = kGateUp ? 64 : 128;
  float acc0[kAcc];
  float acc1[kGateUp ? 64 : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kGateUp ? 64 : 1); ++i) acc1[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    // this thread's pieces of tile kt have landed (one younger group may be in flight)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3));
    wgmma::fence_proxy_async();
    // every thread's pieces are in place, and every warpgroup has finished
    // tile kt - 2's product, so its stage takes tile kt + 2
    __syncthreads();
    if (kt + kStages - 2 < n_k) load_stage(kt + kStages - 2);
    asm volatile("cp.async.commit_group;\n");
    wgmma::mbar_wait(&full[kt % kStages], (kt / kStages) & 1);

    const uint32_t st = wgmma::smem_u32(smem + (kt % kStages) * kStageBytes);
    const uint32_t a_base = st + wg * 64 * 128;
    const uint32_t w_base = st + kABytes;
    wgmma::fence_operand(acc0);
    wgmma::fence_operand(acc1);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = wgmma::desc_sw128(a_base + kk * 32, 16, 1024);
      if constexpr (kGateUp) {
        wgmma::mma_ss_m64n128k16<0>(acc0, da, wgmma::desc_sw128(w_base + kk * 32, 16, 1024), 1);
        wgmma::mma_ss_m64n128k16<0>(acc1, da, wgmma::desc_sw128(w_base + 2 * kBoxBytes + kk * 32, 16, 1024), 1);
      } else {
        wgmma::mma_ss_m64n256k16<0>(acc0, da, wgmma::desc_sw128(w_base + kk * 32, 16, 1024), 1);
      }
    }
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(acc0);
    wgmma::fence_operand(acc1);
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc0);
  wgmma::fence_operand(acc1);

  // epilogue: warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + wg * 64 + warp * 16 + g + half * 8;
    if (row >= row_end) continue;
    __nv_bfloat16* dst = out + static_cast<int64_t>(row) * n_out + n0 + 2 * t;
    if constexpr (kGateUp) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float g0 = acc0[4 * i + 2 * half], g1 = acc0[4 * i + 2 * half + 1];
        const float h0 = g0 / (1.f + __expf(-g0)) * acc1[4 * i + 2 * half];
        const float h1 = g1 / (1.f + __expf(-g1)) * acc1[4 * i + 2 * half + 1];
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(h0, h1);
      }
    } else {
      const float w = __ldg(route_w + __ldg(perm + row));
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
            __floats2bfloat162_rn(w * acc0[4 * i + 2 * half], w * acc0[4 * i + 2 * half + 1]);
      }
    }
  }
}

template <bool kGateUp>
cudaError_t launch_product(const void* a, const void* w, void* out, const void* perm, const void* route_w,
                           const void* counts, const void* offsets, int n_experts, int n_pairs, int depth,
                           int n_out, int top_k, cudaStream_t stream) {
  CUtensorMap map;
  const int w_rows = n_experts * (kGateUp ? 2 * n_out : n_out);
  cudaError_t err = wgmma::box_map(&map, w, w_rows, depth);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(grouped_product<kGateUp>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((n_pairs + kBM - 1) / kBM + n_experts, n_out / (kGateUp ? kWRows / 2 : kWRows));
  grouped_product<kGateUp><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), map, static_cast<__nv_bfloat16*>(out), static_cast<const int*>(perm),
      static_cast<const float*>(route_w), static_cast<const int*>(counts), static_cast<const int*>(offsets),
      n_experts, depth, n_out, top_k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 values of the sort's workspace for n_pairs pairs: each CTA's counts
int moe_sort_workspace(int n_pairs) {
  return ((n_pairs + sort_per_cta(n_pairs) - 1) / sort_per_cta(n_pairs) + 1) * kMaxBuckets;
}

// ids int32 [n_pairs] in [0, n_experts] -> perm, inv int32 [n_pairs],
// counts, offsets int32 [n_experts + 1]; tally int64 [n_experts, 2] or null;
// workspace int32 [moe_sort_workspace(n_pairs)]. n_experts at most 256. Two
// launches: the CTAs' counts, then the scatter.
int moe_sort_pairs(const void* ids, int n_pairs, int n_experts, void* perm, void* inv, void* counts,
                   void* offsets, void* tally, void* workspace, void* stream) {
  if (n_experts < 1 || n_experts + 1 > kMaxBuckets || n_pairs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = sort_per_cta(n_pairs);
  const int ctas = n_pairs > 0 ? (n_pairs + per_cta - 1) / per_cta : 1;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int*>(ids);
  auto* ws = static_cast<int*>(workspace);
  sort_pairs_kernel<false><<<ctas, kSortThreads, 0, s>>>(id, n_pairs, n_experts, per_cta, ws, nullptr, nullptr,
                                                         nullptr, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_pairs_kernel<true><<<ctas, kSortThreads, 0, s>>>(
      id, n_pairs, n_experts, per_cta, ws, static_cast<int*>(perm), static_cast<int*>(inv),
      static_cast<int*>(counts), static_cast<int*>(offsets), static_cast<long long*>(tally));
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [T, hidden], w bf16 [E, 2 inter, hidden] -> h bf16 [n_pairs, inter]
// (sorted order; rows of dropped pairs left as they were). hidden a multiple
// of 64, inter of 128; pointers 16-byte aligned.
int moe_grouped_gate_up(const void* x, const void* w, void* h, const void* perm, const void* counts,
                        const void* offsets, int n_experts, int n_pairs, int hidden, int inter, int top_k,
                        void* stream) {
  if (hidden % kBK || inter % (kWRows / 2) || n_experts < 1 || top_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_product<true>(x, w, h, perm, nullptr, counts, offsets, n_experts, n_pairs, hidden,
                                               inter, top_k, static_cast<cudaStream_t>(stream)));
}

// h bf16 [n_pairs, inter] (sorted), w bf16 [E, hidden, inter], route_w f32
// [n_pairs] (pair order) -> y bf16 [n_pairs, hidden] (sorted). inter a
// multiple of 64, hidden of 256; pointers 16-byte aligned.
int moe_grouped_down(const void* h, const void* w, void* y, const void* perm, const void* route_w,
                     const void* counts, const void* offsets, int n_experts, int n_pairs, int hidden, int inter,
                     void* stream) {
  if (inter % kBK || hidden % kWRows || n_experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_product<false>(h, w, y, perm, route_w, counts, offsets, n_experts, n_pairs, inter,
                                                hidden, 1, static_cast<cudaStream_t>(stream)));
}

const char* moe_dispatch_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
