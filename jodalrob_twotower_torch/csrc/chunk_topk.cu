// Exact running top-k of an index scan for Hopper (sm_90a): chunk_topk.
//
// Replaces no TPU kernel. The reference selects with jax.lax.top_k (and, on
// a TPU only, approx_max_k) and leaves both to XLA
// (jodalrob_twotower_tpu/serving/index.py `_select_topk`, `_merge_topk`).
// The port's scan called torch.topk on every [Q, C] score block and merged
// with a second torch.topk; radix passes re-read each block several times,
// and that selection took half of each serving cell's card time.
//
// Function (one step of serving/index._scanned_topk): the running top k of
// each query, run_s [Q, k] float32 descending with run_i [Q, k] int64 rows,
// becomes the best k of itself and the columns of a score block whose global
// row (row0 + column) lies below the valid count, ordered by score
// descending and, at equal scores, by the lower row, as jax.lax.top_k breaks
// ties. Slots no valid row fills keep the padding entry (float32 minimum,
// row 0) the scan starts from. Scores must not be NaN.
//
// Bound: bytes. Each score of the block is read once: a [256, 262,144]
// float32 chunk is 268 MB, 0.080 ms at 3.35 TB/s. The running top-k and the
// candidates are a few hundred kB, in L2.
//
// Design. A step is two launches on the caller's stream, with no host sync:
//   1. Slice select: a CTA per (query row, slice of 8,192 columns). Its 256
//      threads load the slice once, 32 scores a thread in registers, with
//      16-byte streaming loads (8 in flight a thread), and count the scores
//      above the row's running k-th score, the threshold. Past the first
//      chunk almost every slice counts none and exits. Where at most k pass,
//      they are written out; where more pass, a radix select in shared
//      memory (8 bits a pass over per-warp histograms, from the top of the
//      key) finds the slice's own k-th and exactly k are written. A slice
//      therefore emits at most k candidates, the buffer is Q x slices x k,
//      and it never overflows, whatever the order of the data.
//   2. Merge: a CTA per query row takes the running k and that row's
//      candidates. A few candidates (at most 256) merge by rank: each
//      entry's place is counted against the others, and every entry whose
//      place is below k is written there. More (the first chunk, or data
//      sorted ascending) go through the same radix select over the union,
//      and the chosen k are sorted in shared memory (bitonic). It writes the
//      new top k in place, so its last score is the next step's threshold,
//      and clears the row's candidate count.
// Order is by a 64-bit key: the score's bits turned monotone (-0.0 as +0.0)
// above the complement of the row, so a larger key is a better entry, and
// the answer does not depend on the order in which CTAs wrote candidates.
// A step reads at most 32 slices (262,144 columns); the wrapper runs a wider
// block as several steps.
//
// A device tally, three counters the wrapper keeps on the card: slices seen,
// slices that ran the select, and candidates emitted.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // slice select
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                  // 16-byte loads a thread
constexpr int kPer = kLoads * 4;           // scores a thread holds
constexpr int kSlice = kThreads * kPer;    // 8,192 columns a CTA
constexpr int kMaxSlices = 32;
constexpr int kWindow = kSlice * kMaxSlices;  // 262,144 columns a step
constexpr int kMergeThreads = 512;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kFastMerge = 256;            // candidates a row merges by rank

// the score's bits, monotone in its value; -0.0 counts as +0.0
__device__ __forceinline__ uint32_t monotone(float v) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t entry_key(float v, uint32_t row) {
  return (static_cast<uint64_t>(monotone(v)) << 32) | (0xffffffffu - row);
}

__device__ __forceinline__ int64_t key_row(uint64_t key) {
  return static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(key));
}

// The cut a radix select leaves: keys whose masked bits exceed `prefix` are
// all taken (`above` of them), and `equal` of those whose masked bits equal
// it (all of them, unless keys repeat).
struct Cut {
  uint64_t prefix, mask;
  int above, equal;
};

// The need-th largest key (need >= 1, at most the number of keys) among the
// keys the CTA's threads visit: `visit(f)` calls f(key, score) for each of
// the calling thread's entries. A pass counts the next 8 bits of the keys
// that match the prefix found so far, in a histogram per warp; it stops once
// the bucket of the need-th key holds exactly the keys still needed.
template <int W, typename Visit>
__device__ Cut select_kth(Visit visit, int need, uint32_t* hist, int* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t prefix = 0, mask = 0;
  int above = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < W * 256; i += W * 32) hist[i] = 0;
    __syncthreads();
    uint32_t* mine = hist + warp * 256;
    visit([&](uint64_t key, float) {
      if ((key & mask) == prefix) atomicAdd(&mine[(key >> shift) & 255], 1u);
    });
    __syncthreads();
    for (int b = tid; b < 256; b += W * 32) {
      uint32_t t = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) t += hist[w * 256 + b];
      hist[b] = t;
    }
    __syncthreads();
    if (warp == 0) {  // lane l holds buckets 255 - 8l ... 248 - 8l
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (c[j] = hist[255 - 8 * lane - j]);
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t acc = incl - sum;
      if (acc < static_cast<uint32_t>(need) && static_cast<uint32_t>(need) <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= static_cast<uint32_t>(need)) {
            scratch[0] = 255 - 8 * lane - j;
            scratch[1] = static_cast<int>(acc);
            scratch[2] = static_cast<int>(c[j]);
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    const int digit = scratch[0], higher = scratch[1], in_bucket = scratch[2];
    __syncthreads();  // scratch and hist are written again by the next pass
    above += higher;
    need -= higher;
    prefix |= static_cast<uint64_t>(digit) << shift;
    mask |= static_cast<uint64_t>(0xff) << shift;
    if (in_bucket == need) break;
  }
  return {prefix, mask, above, need};
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads, 2)
slice_select_kernel(const float* __restrict__ scores, int64_t ld, int slices, int64_t row0, int valid_cols,
                    const float* __restrict__ run_s, int k, int* __restrict__ counts, float* __restrict__ cand_s,
                    uint32_t* __restrict__ cand_r, int64_t cap, unsigned long long* __restrict__ tally) {
  __shared__ uint32_t hist[kWarps * 256];
  __shared__ int warp_sum[kWarps];
  __shared__ int scratch[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / slices, c0 = (blockIdx.x % slices) * kSlice;
  const float* row = scores + static_cast<int64_t>(q) * ld;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = c0 + 4 * (i * kThreads + tid);  // a warp's loads cover 512 contiguous bytes
    if (kVec4) {
      float4 x = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      if (c < valid_cols) x = __ldcs(reinterpret_cast<const float4*>(row + c));
      v[4 * i] = x.x;
      v[4 * i + 1] = c + 1 < valid_cols ? x.y : -CUDART_INF_F;
      v[4 * i + 2] = c + 2 < valid_cols ? x.z : -CUDART_INF_F;
      v[4 * i + 3] = c + 3 < valid_cols ? x.w : -CUDART_INF_F;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * i + j] = c + j < valid_cols ? __ldcs(row + c + j) : -CUDART_INF_F;
    }
  }
  // the threshold: the row's running k-th score (the float32 minimum while
  // fewer than k rows were seen); only scores above it can enter
  const float thr = run_s[static_cast<int64_t>(q) * k + k - 1];
  int mine = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) mine += v[e] > thr;
  const int w = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) warp_sum[warp] = w;
  __syncthreads();
  int passing = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) passing += warp_sum[i];
  if (passing == 0) {
    if (tid == 0) atomicAdd(&tally[0], 1ull);
    return;
  }
  // column of score e of this thread: c0 + 4 (e / 4 * kThreads + tid) + e % 4
  const uint32_t row_base = static_cast<uint32_t>(row0 + c0 + 4 * tid);
  auto visit = [&](auto f) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (v[e] > thr) f(entry_key(v[e], row_base + 4 * (e / 4) * kThreads + e % 4), v[e]);
    }
  };
  Cut cut{0, 0, 0, 0};
  const bool select = passing > k;
  if (select) {
    cut = select_kth<kWarps>(visit, k, hist, scratch);
    mine = 0;
    visit([&](uint64_t key, float) { mine += (key & cut.mask) >= cut.prefix; });
  }
  // every key of a slice is distinct, so the cut takes exactly k
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    before += i < warp ? warp_sum[i] : 0;
    total += warp_sum[i];
  }
  if (tid == 0) {
    scratch[3] = atomicAdd(&counts[q], total);
    atomicAdd(&tally[0], 1ull);
    if (select) atomicAdd(&tally[1], 1ull);
    atomicAdd(&tally[2], static_cast<unsigned long long>(total));
  }
  __syncthreads();
  int64_t at = static_cast<int64_t>(q) * cap + scratch[3] + before + incl - mine;
  visit([&](uint64_t key, float s) {
    if (!select || (key & cut.mask) >= cut.prefix) {
      cand_s[at] = s;
      cand_r[at] = static_cast<uint32_t>(key_row(key));
      ++at;
    }
  });
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(float* __restrict__ run_s, int64_t* __restrict__ run_i, int k, int* __restrict__ counts,
             const float* __restrict__ cand_s, const uint32_t* __restrict__ cand_r, int64_t cap) {
  __shared__ uint32_t hist[kMergeWarps * 256];
  __shared__ uint64_t skey[kMaxK];  // the running keys (by rank), or the chosen k (select)
  __shared__ float sval[kMaxK];
  __shared__ uint64_t ckey[kFastMerge];
  __shared__ float cval[kFastMerge];
  __shared__ int scratch[4];
  const int tid = threadIdx.x, q = blockIdx.x;
  const int n = counts[q];
  if (n == 0) return;
  float* rs = run_s + static_cast<int64_t>(q) * k;
  int64_t* ri = run_i + static_cast<int64_t>(q) * k;
  const float* cs = cand_s + static_cast<int64_t>(q) * cap;
  const uint32_t* cr = cand_r + static_cast<int64_t>(q) * cap;
  if (n <= kFastMerge) {
    // by rank: no candidate ties a running entry (rows differ), and running
    // entries keep their own order, so the places are a permutation
    for (int t = tid; t < k; t += kMergeThreads) {
      skey[t] = entry_key(rs[t], static_cast<uint32_t>(ri[t]));
      sval[t] = rs[t];
    }
    for (int t = tid; t < n; t += kMergeThreads) {
      ckey[t] = entry_key(cs[t], cr[t]);
      cval[t] = cs[t];
    }
    __syncthreads();
    for (int t = tid; t < k; t += kMergeThreads) {
      const uint64_t key = skey[t];
      int place = t;
      for (int c = 0; c < n; ++c) place += ckey[c] > key;
      if (place < k) {
        rs[place] = sval[t];
        ri[place] = key_row(key);
      }
    }
    for (int t = tid; t < n; t += kMergeThreads) {
      const uint64_t key = ckey[t];
      int lo = 0, hi = k;  // running keys above it: they are sorted descending
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (skey[mid] > key) lo = mid + 1; else hi = mid;
      }
      int place = lo;
      for (int c = 0; c < n; ++c) place += ckey[c] > key;
      if (place < k) {
        rs[place] = cval[t];
        ri[place] = key_row(key);
      }
    }
  } else {
    auto visit = [&](auto f) {
      for (int t = tid; t < k; t += kMergeThreads) f(entry_key(rs[t], static_cast<uint32_t>(ri[t])), rs[t]);
      for (int t = tid; t < n; t += kMergeThreads) f(entry_key(cs[t], cr[t]), cs[t]);
    };
    const Cut cut = select_kth<kMergeWarps>(visit, k, hist, scratch);
    if (tid == 0) scratch[0] = scratch[1] = 0;
    __syncthreads();
    // keys repeat only in padding entries, which are equal: any of them will do
    visit([&](uint64_t key, float s) {
      const uint64_t m = key & cut.mask;
      int slot = -1;
      if (m > cut.prefix) {
        slot = atomicAdd(&scratch[0], 1);
      } else if (m == cut.prefix) {
        slot = atomicAdd(&scratch[1], 1);
        slot = slot < cut.equal ? cut.above + slot : -1;
      }
      if (slot >= 0) {
        skey[slot] = key;
        sval[slot] = s;
      }
    });
    int p = 1;
    while (p < k) p <<= 1;
    for (int t = k + tid; t < p; t += kMergeThreads) {
      skey[t] = 0;
      sval[t] = 0.0f;
    }
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < p; i += kMergeThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const uint64_t a = skey[i], b = skey[j];
            if (((i & size) == 0) ? a < b : a > b) {  // descending overall
              skey[i] = b;
              skey[j] = a;
              const float t = sval[i];
              sval[i] = sval[j];
              sval[j] = t;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int t = tid; t < k; t += kMergeThreads) {
      rs[t] = sval[t];
      ri[t] = key_row(skey[t]);
    }
  }
  __syncthreads();
  if (tid == 0) counts[q] = 0;
}

}  // namespace

extern "C" {

// One step over the score block's columns [0, cols) (cols <= 262,144),
// whose row stride is ld floats: column c is global row row0 + c and valid
// below valid_cols. run_s [q, k] f32 and run_i [q, k] int64 are updated in
// place. Workspace: counts [q] int32, zero on entry and left zero; cand_s
// [q, cap] f32 and cand_r [q, cap] int32 with cap >= slices * k; tally
// [3] uint64 on the card, added to.
int chunk_topk_step(float* run_s, long long* run_i, const float* scores, long long ld, int q, int k, int cols,
                    long long row0, int valid_cols, int* counts, float* cand_s, unsigned* cand_r, long long cap,
                    unsigned long long* tally, void* stream) {
  const int slices = (cols + kSlice - 1) / kSlice;
  if (q <= 0 || k <= 0 || k > kMaxK || cols <= 0 || cols > kWindow || valid_cols < 0 || valid_cols > cols ||
      ld < cols || row0 < 0 || row0 + cols > 0x7fffffffLL || cap < static_cast<long long>(slices) * k ||
      static_cast<long long>(q) * slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = ld % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(q * slices);
  if (vec4) {
    slice_select_kernel<true><<<grid, kThreads, 0, s>>>(scores, ld, slices, row0, valid_cols, run_s, k, counts,
                                                        cand_s, cand_r, cap, tally);
  } else {
    slice_select_kernel<false><<<grid, kThreads, 0, s>>>(scores, ld, slices, row0, valid_cols, run_s, k, counts,
                                                         cand_s, cand_r, cap, tally);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<q, kMergeThreads, 0, s>>>(run_s, reinterpret_cast<int64_t*>(run_i), k, counts, cand_s, cand_r, cap);
  return static_cast<int>(cudaGetLastError());
}

// the constants the wrapper sizes its workspace by
int chunk_topk_slice() { return kSlice; }
int chunk_topk_window() { return kWindow; }
int chunk_topk_max_k() { return kMaxK; }

const char* chunk_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
