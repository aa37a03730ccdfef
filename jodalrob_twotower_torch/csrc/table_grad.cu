// Dense table gradient of the unified embedding table for Hopper (sm_90a).
//
// Replaces the TPU kernels jodalrob_twotower_tpu/ops/embedding_grad.py:45
// `_grad_kernel` (both orientations; called through `_dense_table_grad`,
// `dense_table_grad` and `dense_table_grad_t`): entry point `table_grad`,
// [R, D] out; and :227 `_grad_kernel_bmajor` (called through
// `dense_table_grad_bmajor`): entry point `table_grad_bmajor`, the same sums
// stored transposed, [D, R], as that kernel returns them. Both compute what
// the TPU kernels compute, dense over all R rows of the table:
//
//   dT[v, :] = sum over b with rows[b, k] == v of f32(g[b, k, :]),
//              k = tile_feature[v / 128], the feature that owns v's tile
//
// so an id outside its own feature's 128-aligned block (another feature's
// rows, -1 padding, a row past the table) contributes nothing, matching the
// one-hot lookup's forward (onehot_lookup.cu).
//
// Design. The TPU built [B, 128] one-hot tiles in VMEM and ran them through
// the MXU, and needed g relaid out as [K, D, B] for its lanes. On Hopper it
// is a segmented sum, read from g in its native [B, K, D] bf16 layout:
//   - one block per 128-row tile of the table; the block scans its feature's
//     column of ids in chunks of 4,096 staged through shared memory;
//   - the matches of a chunk are grouped by table row with a stable counting
//     sort (per-warp counts, then each warp places its segment in batch
//     order with __match_any_sync), so every row's list is in batch order;
//   - two threads own each table row (half of D each) and add its g rows in
//     f32 in that order, 16 loads of 16 bytes in flight; the sum is carried in
//     registers across chunks and written once.
// No float atomics anywhere: the order of every sum is fixed, so two calls
// give the same bits (resume exactness relies on it), and the [D, R] form is
// the [R, D] form transposed, bit for bit. The TPU's B-major kernel existed
// to read g without a [K, D, B] relayout; this design reads g natively in
// both forms, so only the store differs: for each of its dims a warp writes
// two runs of 16 consecutive rows, whole 32-byte sectors.
//
// Bound: bytes. The ids (B K 4 bytes) and g (B K D 2 bytes) are read once and
// the f32 table gradient (R D 4 bytes) written once: at the notice shape
// (B = 8192, K = 32, D = 32, R = 32,768) 1 + 16.8 + 4.2 MB, about 0.0066 ms at
// 3.35 TB/s. A row hit by many ids is summed by one pair of threads, so
// heavily skewed ids set the time of their tile.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;
constexpr int kThreads = 256;  // two threads per table row
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;   // ids staged per pass
constexpr unsigned kFull = 0xffffffffu;

template <int D, bool kTransposed>
__global__ void __launch_bounds__(kThreads)
table_grad_kernel(const int32_t* __restrict__ rows, const __nv_bfloat16* __restrict__ g,
                  const int32_t* __restrict__ tile_feature, float* __restrict__ out, int b,
                  int k, int total_rows) {
  constexpr int kHalf = D / 2;        // dims per thread
  constexpr int kVecs = kHalf / 8;    // 16-byte pieces per thread and g row
  constexpr int kInFlight = 16 / kVecs;  // g rows loaded before they are added
  __shared__ int32_t local[kChunk];   // local row of each id of the chunk, or -1
  __shared__ int32_t order[kChunk];   // batch index of each match, grouped by row
  __shared__ int32_t cursor[kWarps][kTileRows];
  __shared__ int32_t row_start[kTileRows + 1];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x;
  const int feature = tile_feature[tile];
  const int row0 = tile * kTileRows;
  const int my_row = tid / 2, my_half = tid % 2;

  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < b; c0 += kChunk) {
    const int n = min(kChunk, b - c0);
    for (int i = tid; i < n; i += kThreads) {
      const int r = __ldg(rows + static_cast<int64_t>(c0 + i) * k + feature) - row0;
      local[i] = (r >= 0 && r < kTileRows) ? r : -1;
    }
    for (int i = tid; i < kWarps * kTileRows; i += kThreads) (&cursor[0][0])[i] = 0;
    __syncthreads();

    // each warp owns one contiguous segment of the chunk
    const int seg = (n + kWarps - 1) / kWarps;
    const int s0 = min(n, warp * seg), s1 = min(n, s0 + seg);
    for (int i = s0 + lane; i < s1; i += 32) {
      const int r = local[i];
      if (r >= 0) atomicAdd(&cursor[warp][r], 1);  // integer counts: order-free
    }
    __syncthreads();
    // cursor[w][r] <- matches of row r in the segments before w; row totals
    if (tid < kTileRows) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = cursor[w][tid];
        cursor[w][tid] = run;
        run += cnt;
      }
      row_start[tid + 1] = run;
    }
    __syncthreads();
    if (tid == 0) {
      row_start[0] = 0;
      for (int r = 1; r <= kTileRows; ++r) row_start[r] += row_start[r - 1];
    }
    __syncthreads();
    // stable placement: 32 ids at a time, in batch order within the segment
    for (int base = s0; base < s1; base += 32) {
      const int i = base + lane;
      const int r = i < s1 ? local[i] : -1;
      const unsigned peers = __match_any_sync(kFull, r);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (r >= 0) order[row_start[r] + cursor[warp][r] + rank] = c0 + i;
      __syncwarp();
      if (r >= 0 && rank == 0) cursor[warp][r] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // this thread's row, in batch order
    const int beg = row_start[my_row], end = row_start[my_row + 1];
    for (int m0 = beg; m0 < end; m0 += kInFlight) {
      uint4 v[kInFlight][kVecs];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (m0 + q < end) {
          const uint4* src = reinterpret_cast<const uint4*>(
              g + (static_cast<int64_t>(order[m0 + q]) * k + feature) * D + my_half * kHalf);
#pragma unroll
          for (int p = 0; p < kVecs; ++p) v[q][p] = __ldg(src + p);
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (m0 + q < end) {
#pragma unroll
          for (int p = 0; p < kVecs; ++p) {
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[q][p]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              acc[p * 8 + 2 * e] += f.x;
              acc[p * 8 + 2 * e + 1] += f.y;
            }
          }
        }
      }
    }
    __syncthreads();  // local and order are refilled by the next chunk
  }

  if constexpr (kTransposed) {  // out [D, total_rows]
    float* dst = out + static_cast<int64_t>(my_half * kHalf) * total_rows + row0 + my_row;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) dst[static_cast<int64_t>(e) * total_rows] = acc[e];
  } else {  // out [total_rows, D]
    float* dst = out + static_cast<int64_t>(row0 + my_row) * D + my_half * kHalf;
#pragma unroll
    for (int p = 0; p < kHalf / 4; ++p) {
      reinterpret_cast<float4*>(dst)[p] =
          make_float4(acc[4 * p], acc[4 * p + 1], acc[4 * p + 2], acc[4 * p + 3]);
    }
  }
}

template <int D, bool kTransposed>
int launch(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
           int total_rows, cudaStream_t stream) {
  table_grad_kernel<D, kTransposed><<<total_rows / kTileRows, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const __nv_bfloat16*>(g),
      static_cast<const int32_t*>(tile_feature), static_cast<float*>(out), b, k, total_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransposed>
int dispatch(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
             int d, int total_rows, void* stream) {
  if (total_rows <= 0 || total_rows % kTileRows || b < 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16, kTransposed>(rows, g, tile_feature, out, b, k, total_rows, s);
    case 32: return launch<32, kTransposed>(rows, g, tile_feature, out, b, k, total_rows, s);
    case 64: return launch<64, kTransposed>(rows, g, tile_feature, out, b, k, total_rows, s);
    case 128: return launch<128, kTransposed>(rows, g, tile_feature, out, b, k, total_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// rows [b, k] i32 absolute table rows, g [b, k, d] bf16, tile_feature
// [total_rows / 128] i32 -> out [total_rows, d] f32 (every row written).
// d in {16, 32, 64, 128}; g and out 16-byte aligned (the wrapper checks).
int table_grad(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
               int d, int total_rows, void* stream) {
  return dispatch<false>(rows, g, tile_feature, out, b, k, d, total_rows, stream);
}

// The same inputs -> out [d, total_rows] f32: table_grad's result transposed.
int table_grad_bmajor(const void* rows, const void* g, const void* tile_feature, void* out, int b,
                      int k, int d, int total_rows, void* stream) {
  return dispatch<true>(rows, g, tile_feature, out, b, k, d, total_rows, stream);
}

const char* table_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
