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
// Bound: bytes. The ids (B K 4 bytes) and g (B K D 2 bytes) are read once and
// the f32 table gradient (R D 4 bytes) written once: at the notice shape
// (B = 8192, K = 32, D = 32, R = 32,768) 1 + 16.8 + 4.2 MB, about 0.0066 ms at
// 3.35 TB/s. What sets the time is latency: each 128-row tile must find its
// matches among all B ids of its feature, a chain of dependent steps (load
// the ids, group them by row, sum each row's g rows in batch order).
//
// Design. The TPU built [B, 128] one-hot tiles in VMEM and ran them through
// the MXU. On Hopper it is a segmented sum, read from g in its native
// [B, K, D] bf16 layout, and each tile's chain is split over a thread-block
// cluster of C CTAs (C in {1, 2, 4, 8}, chosen by the wrapper from the shape;
// grid C x R/128, cluster C x 1 x 1):
//   - CTA s of a tile scans only ids [s B/C, (s+1) B/C) of the tile's
//     feature, in chunks staged through shared memory: each warp loads its
//     segment of the chunk (eight ids a lane in flight) and numbers the
//     matches of each row in batch order with __match_any_sync; one block
//     scan turns the per-warp counts into each row's place, and the chunk's
//     matches land grouped by row, in batch order (a stable counting sort);
//   - each row's list is cut into sub-lists of at most 8 matches; in rounds
//     of 128, thread pair p (half of D each) adds the g rows of sub-list p in
//     f32, in batch order, sixteen loads in flight a thread (16-byte pieces
//     where half of D is a multiple of 8 dims, else 8-byte ones), into a
//     slot; then the pair that owns the row adds its sub-lists' slots, in
//     order, to the row's sum in the CTA's [128, D] f32 partial (shared
//     memory), which carries it across chunks. A row hit by thousands of ids
//     is summed by up to 128 pairs at once;
//   - after cluster.sync(), CTA s finalizes rows [s 128/C, (s+1) 128/C) of
//     the tile: it reads them from the partials of ranks 0, 1, ..., C-1, in
//     that order, through distributed shared memory, adds them in f32 and
//     stores the result; a second cluster.sync() keeps every CTA's shared
//     memory alive until the others have read it.
// So a tile's chain is B/C ids long instead of B, and the grid has C times
// the CTAs. No global scratch, no second launch, no float atomics: the order
// of every sum is fixed by the inputs (C by their shape, the sub-lists by the
// ids), so two calls give the same bits (resume exactness relies on it),
// and the [D, R] form is the [R, D] form transposed, bit for
// bit: the same partials, the same merge, another store (K2 writes float4
// pieces of whole rows; K3 writes, for each dim, a run of 128/C consecutive
// rows). C = 1 is the one-CTA-per-tile case: its merge reads one partial.
//
// Known limit: every tile reads all B ids of its feature's column, one 4-byte
// load per id (a sector each at K >= 8), so the tiles together read R/128 x B
// ids from L2 whatever C is. That grows with R: at R = 65,536 it is 512 x B
// sector reads, against the B K ids the function needs.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// first CUDA error of setting the kernel's shared-memory size or of its
// cluster launch (a refused launch is reported, never retried another way).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 128;
constexpr int kThreads = 256;  // two threads per table row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 2048;  // ids staged per pass
constexpr int kIdBatch = 8;      // id loads in flight a lane
constexpr int kSub = 8;          // matches per sub-list, summed by one thread pair
constexpr int kMaxSubLists = kMaxChunk / kSub + kTileRows;  // a chunk's sub-lists, at most
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: the tile's [128, D + 4] f32 row sums (the CTA's partial;
// the pad keeps float4 reads of a column of rows free of bank conflicts), as
// many slots for sub-list sums, the per-warp row counts, the row and sub-list
// starts, the block scan's warp totals, each sub-list's row, then the chunk's
// staging arrays.
template <int D>
constexpr int kPartialStride = D + 4;

template <int D>
size_t smem_bytes(int chunk) {
  return sizeof(float) * 2 * kTileRows * kPartialStride<D> +
         sizeof(int32_t) * (kWarps * kTileRows + 2 * (kTileRows + 4) + 4 + kMaxSubLists + 2 * chunk);
}

// ptxas's register cap: two CTAs per SM at the narrow widths (the training
// path's D = 32, where sixteen loads in flight a thread served it better
// than three CTAs with eight), none where the wider sums need the registers
template <int D>
constexpr int kMinBlocks = D <= 32 ? 2 : 1;

// The piece a thread loads of its half of a g row: 16 bytes (8 dims) where
// the half is a multiple of 8 dims, else 8 bytes (4 dims), since a half of
// 4, 12, 20, ... dims starts only 8-byte aligned (D = 8, 24, 40, ...)
template <int D>
using GPiece = typename std::conditional<(D / 2) % 8 == 0, uint4, uint2>::type;

// part[0..D/2) += f32(g rows order[beg..end) of `feature`, this thread's half
// of D), in that order, with kInFlight rows' loads in flight
template <int D>
__device__ __forceinline__ void add_g_rows(float* part, const __nv_bfloat16* __restrict__ g,
                                           const int32_t* order, int beg, int end, int k, int feature,
                                           int half) {
  using Piece = GPiece<D>;
  constexpr int kHalf = D / 2;
  constexpr int kPieceDims = static_cast<int>(sizeof(Piece)) / 2;
  constexpr int kVecs = kHalf / kPieceDims;  // pieces per thread and g row
  constexpr int kInFlight = kVecs >= 16 ? 1 : 16 / kVecs;
  for (int m0 = beg; m0 < end; m0 += kInFlight) {
    Piece v[kInFlight][kVecs];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (m0 + q < end) {
        const Piece* src = reinterpret_cast<const Piece*>(
            g + (static_cast<int64_t>(order[m0 + q]) * k + feature) * D + half * kHalf);
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
          for (int e = 0; e < kPieceDims / 2; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            part[p * kPieceDims + 2 * e] += f.x;
            part[p * kPieceDims + 2 * e + 1] += f.y;
          }
        }
      }
    }
  }
}

template <int D, bool kTransposed>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
table_grad_kernel(const int32_t* __restrict__ rows, const __nv_bfloat16* __restrict__ g,
                  const int32_t* __restrict__ tile_feature, float* __restrict__ out, int b,
                  int k, int total_rows, int chunk) {
  constexpr int kStride = kPartialStride<D>;
  constexpr int kHalf = D / 2;  // dims per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* partial = reinterpret_cast<float*>(smem);  // [128][kStride] the tile's row sums
  float* slots = partial + kTileRows * kStride;     // [128][kStride] one round's sub-list sums
  int32_t* cursor = reinterpret_cast<int32_t*>(slots + kTileRows * kStride);  // [kWarps][128]
  int32_t* row_start = cursor + kWarps * kTileRows;  // [129]: row r's matches, order[row_start[r]..)
  int32_t* sub_start = row_start + kTileRows + 4;    // [129]: row r's first sub-list
  int32_t* warp_total = sub_start + kTileRows + 4;   // [4]
  int32_t* sub_row = warp_total + 4;                 // [kMaxSubLists]: the row of each sub-list
  // each warp's matches of the chunk, compacted in batch order at the start
  // of its segment: (row << 22) | (place in its warp's list of the row << 11) | id
  int32_t* local = sub_row + kMaxSubLists;
  int32_t* order = local + chunk;  // batch index of each match, grouped by row

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x / n_cta;
  const int feature = tile_feature[tile];
  const int row0 = tile * kTileRows;
  const int my_row = tid / 2, my_half = tid % 2;
  const int s0 = static_cast<int>(static_cast<int64_t>(rank) * b / n_cta);
  const int s1 = static_cast<int>(static_cast<int64_t>(rank + 1) * b / n_cta);
  int32_t* count = cursor + warp * kTileRows;
  float4* my_sum = reinterpret_cast<float4*>(partial + my_row * kStride + my_half * kHalf);
  float4* my_slot = reinterpret_cast<float4*>(slots + my_row * kStride + my_half * kHalf);

#pragma unroll
  for (int p = 0; p < kHalf / 4; ++p) my_sum[p] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c0 = s0; c0 < s1; c0 += chunk) {
    const int n = min(chunk, s1 - c0);
    // each warp numbers the matches of its contiguous segment, row by row
    const int seg = (n + kWarps - 1) / kWarps;
    const int w0 = min(n, warp * seg), w1 = min(n, w0 + seg);
    for (int r = lane; r < kTileRows; r += 32) count[r] = 0;
    __syncwarp();
    int n_match = 0;  // this warp's matches so far
    for (int base = w0; base < w1; base += 32 * kIdBatch) {
      int id[kIdBatch];
#pragma unroll
      for (int q = 0; q < kIdBatch; ++q) {
        const int i = base + q * 32 + lane;
        id[q] = i < w1 ? __ldg(rows + static_cast<int64_t>(c0 + i) * k + feature) : -1;
      }
#pragma unroll
      for (int q = 0; q < kIdBatch; ++q) {
        const int i = base + q * 32 + lane;
        const unsigned off = static_cast<unsigned>(id[q]) - static_cast<unsigned>(row0);
        const int r = (i < w1 && off < kTileRows) ? static_cast<int>(off) : -1;
        const unsigned peers = __match_any_sync(kFull, r);
        const int peer_rank = __popc(peers & ((1u << lane) - 1u));
        const int before = r >= 0 ? count[r] : 0;
        __syncwarp();
        if (r >= 0 && peer_rank == 0) count[r] = before + __popc(peers);
        __syncwarp();
        const unsigned hit = __ballot_sync(kFull, r >= 0);
        if (r >= 0) {
          local[w0 + n_match + __popc(hit & ((1u << lane) - 1u))] = (r << 22) | ((before + peer_rank) << 11) | i;
        }
        n_match += __popc(hit);
      }
    }
    __syncthreads();
    // count[w][r] <- matches of row r in the segments before w; then one scan
    // over the first four warps of each row's matches and sub-lists, packed
    // in one int (each total fits 16 bits: at most 2,048 and 384)
    int n_row_sub = 0, incl = 0;
    if (tid < kTileRows) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cnt = cursor[w * kTileRows + tid];
        cursor[w * kTileRows + tid] = run;
        run += cnt;
      }
      n_row_sub = (run + kSub - 1) / kSub;
      incl = run | (n_row_sub << 16);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) warp_total[warp] = incl;
    }
    __syncthreads();
    if (tid < kTileRows) {
      for (int w = 0; w < warp; ++w) incl += warp_total[w];
      row_start[tid + 1] = incl & 0xffff;
      sub_start[tid + 1] = incl >> 16;
      if (tid == 0) row_start[0] = sub_start[0] = 0;
      for (int j = (incl >> 16) - n_row_sub; j < (incl >> 16); ++j) sub_row[j] = tid;
    }
    __syncthreads();
    // stable placement: each warp puts its matches at their row's start +
    // the warp's offset in the row + their place in the warp's list
    for (int m = lane; m < n_match; m += 32) {
      const int v = local[w0 + m];
      const int r = v >> 22;
      order[row_start[r] + count[r] + ((v >> 11) & 0x7ff)] = c0 + (v & 0x7ff);
    }
    __syncthreads();

    // Each row's list, in batch order, is cut into sub-lists of at most kSub
    // matches, numbered row by row. In rounds of 128, thread pair p sums
    // sub-list t0 + p into slot p; then each row's owner pair adds its
    // sub-lists' slots to the row's sum in order. A row hit by thousands of
    // ids is summed by up to 128 pairs at once, in a fixed order.
    const int n_sub = sub_start[kTileRows];
    for (int t0 = 0; t0 < n_sub; t0 += kTileRows) {
      const int j = t0 + my_row;
      float part[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) part[i] = 0.f;
      if (j < n_sub) {
        const int r = sub_row[j];
        const int beg = row_start[r] + (j - sub_start[r]) * kSub;
        add_g_rows<D>(part, g, order, beg, min(beg + kSub, row_start[r + 1]), k, feature, my_half);
      }
#pragma unroll
      for (int p = 0; p < kHalf / 4; ++p) my_slot[p] = make_float4(part[4 * p], part[4 * p + 1], part[4 * p + 2], part[4 * p + 3]);
      __syncthreads();
      const int j0 = max(sub_start[my_row], t0), j1 = min(sub_start[my_row + 1], t0 + kTileRows);
      if (j0 < j1) {
#pragma unroll
        for (int p = 0; p < kHalf / 4; ++p) {
          float4 sum = my_sum[p];
          for (int jj = j0; jj < j1; ++jj) {
            const float4 x = reinterpret_cast<const float4*>(slots + (jj - t0) * kStride + my_half * kHalf)[p];
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
          }
          my_sum[p] = sum;
        }
      }
      __syncthreads();  // the slots are refilled by the next round
    }
  }
  cluster.sync();  // every partial of the tile is complete

  // this CTA's rows of the tile: the partials of ranks 0..C-1 added in rank order
  const int rows_per = kTileRows / n_cta;
  const int r_base = rank * rows_per;
  constexpr int kQuads = D / 4;
  for (int i = tid; i < rows_per * kQuads; i += kThreads) {
    // K3 walks the rows fastest, so its stores run along a dim's rows
    const int r = kTransposed ? i % rows_per : i / kQuads;
    const int q = kTransposed ? i / rows_per : i % kQuads;
    float* const mine = partial + (r_base + r) * kStride + 4 * q;
    float4 part[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < n_cta) part[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, s));
    }
    float4 sum = part[0];
#pragma unroll
    for (int s = 1; s < kMaxCluster; ++s) {
      if (s < n_cta) {
        sum.x += part[s].x;
        sum.y += part[s].y;
        sum.z += part[s].z;
        sum.w += part[s].w;
      }
    }
    const int row = row0 + r_base + r;
    if constexpr (kTransposed) {  // out [D, total_rows]
      float* dst = out + static_cast<int64_t>(4 * q) * total_rows + row;
      dst[0] = sum.x;
      dst[static_cast<int64_t>(total_rows)] = sum.y;
      dst[2 * static_cast<int64_t>(total_rows)] = sum.z;
      dst[3 * static_cast<int64_t>(total_rows)] = sum.w;
    } else {  // out [total_rows, D]
      reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * D)[q] = sum;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

template <int D, bool kTransposed>
int launch(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
           int total_rows, int cluster, cudaStream_t stream) {
  const int slice = (b + cluster - 1) / cluster;
  const int chunk = std::min(kMaxChunk, std::max(kThreads, (slice + kThreads - 1) / kThreads * kThreads));
  const size_t smem = smem_bytes<D>(chunk);
  auto kernel = table_grad_kernel<D, kTransposed>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(total_rows / kTileRows));
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, static_cast<const int32_t*>(rows),
                             static_cast<const __nv_bfloat16*>(g), static_cast<const int32_t*>(tile_feature),
                             static_cast<float*>(out), b, k, total_rows, chunk);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a refusal, so later launches do not see it
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool kTransposed>
int dispatch(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
             int d, int total_rows, int cluster, void* stream) {
  if (total_rows <= 0 || total_rows % kTileRows || b < 0 || k <= 0 || cluster < 1 || kTileRows % cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
#define TABLE_GRAD_WIDTH(W) \
  case W:                   \
    return launch<W, kTransposed>(rows, g, tile_feature, out, b, k, total_rows, cluster, s);
  switch (d) {  // every multiple of 8 up to 128
    TABLE_GRAD_WIDTH(8) TABLE_GRAD_WIDTH(16) TABLE_GRAD_WIDTH(24) TABLE_GRAD_WIDTH(32)
    TABLE_GRAD_WIDTH(40) TABLE_GRAD_WIDTH(48) TABLE_GRAD_WIDTH(56) TABLE_GRAD_WIDTH(64)
    TABLE_GRAD_WIDTH(72) TABLE_GRAD_WIDTH(80) TABLE_GRAD_WIDTH(88) TABLE_GRAD_WIDTH(96)
    TABLE_GRAD_WIDTH(104) TABLE_GRAD_WIDTH(112) TABLE_GRAD_WIDTH(120) TABLE_GRAD_WIDTH(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TABLE_GRAD_WIDTH
}

}  // namespace

extern "C" {

// rows [b, k] i32 absolute table rows, g [b, k, d] bf16, tile_feature
// [total_rows / 128] i32 -> out [total_rows, d] f32 (every row written).
// d a multiple of 8 up to 128; cluster (C) divides 128 and the card must accept
// it as a cluster size (1, 2, 4, 8 portably); g and out 16-byte aligned (the
// wrapper checks).
int table_grad(const void* rows, const void* g, const void* tile_feature, void* out, int b, int k,
               int d, int total_rows, int cluster, void* stream) {
  return dispatch<false>(rows, g, tile_feature, out, b, k, d, total_rows, cluster, stream);
}

// The same inputs -> out [d, total_rows] f32: table_grad's result transposed.
int table_grad_bmajor(const void* rows, const void* g, const void* tile_feature, void* out, int b,
                      int k, int d, int total_rows, int cluster, void* stream) {
  return dispatch<true>(rows, g, tile_feature, out, b, k, d, total_rows, cluster, stream);
}

const char* table_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
