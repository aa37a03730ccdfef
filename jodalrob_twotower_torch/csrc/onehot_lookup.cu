// One-hot embedding lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel jodalrob_twotower_tpu/ops/embedding_grad.py:358
// `_lookup_kernel` (called through dense_table_lookup_t and
// make_onehot_lookup). It computes what that kernel computes:
//
//   out[b, k, :] = bf16(table[rows[b, k], :])  when rows[b, k] lies in
//                  feature k's 128-row-aligned block of the unified table,
//                = 0                           otherwise: a row of another
//                  feature's block, -1 padding, or a row past the table.
//
// Feature k's block is the set of 128-row tiles t with tile_feature[t] == k,
// the ownership map the TPU kernel is driven by.
//
// Design. The TPU computed the lookup as a one-hot matmul per 128-row tile
// because its row DMAs were slow. On Hopper it is a direct row gather,
// emitted in the towers' [B, K*D] layout (no [K, D, B] transpose):
//  - a warp takes kPairs = 16 consecutive (b, k) pairs: lane l < 16 loads
//    pair l's id (one coalesced 64-byte load), tests its ownership once and
//    hands the row to the lanes that copy it with __shfl_sync, so no id or
//    tile entry is loaded twice; 16 pairs and not 32 give the copies twice
//    the warps (on the H100 at the notice shape 0.0143 ms against 0.0158,
//    at the company shape 0.0077 against 0.0082);
//  - the tile map (R/128 int32: 1 KB at the notice shape) is read through
//    the read-only (L1) path, one load per id;
//  - a lane writes whole 16-byte pieces of bf16 output (8 values: two
//    float4 loads of an f32 table, one uint4 of a bf16 table), the warp's
//    16 pairs being one contiguous run of output, so every store is
//    coalesced; a lane issues up to kBatch pieces' loads before it converts
//    any, so the row loads of its pairs are in flight together;
//  - 32-bit index arithmetic (a pair's feature is one 32-bit modulo per
//    lane, a piece's pair a shift when D/8 is a power of two);
//  - one warp per 16 pairs and a grid that covers them once: at the notice
//    shape (B=8192, K=32) 2,048 blocks of 8 warps; at the company shape
//    (K=6) 384 blocks. A persistent grid, or a warp taking two or four runs
//    of ids at once, measured no faster.
// Rounding is __float2bfloat16_rn (round to nearest even, the rounding of
// the plain version's .to(torch.bfloat16)).
//
// Bound: bytes. Each (b, k) pair reads its 4-byte id and writes D*2 bytes;
// the table rows the batch references are read once (repeats hit L2). At
// D=32: a notice batch (B=8192, K=32, table 32,768 rows) moves ~21.9 MB,
// 6.5 us at 3.35 TB/s; a company batch (B=8192, K=6, 6,144 rows) ~4.1 MB,
// 1.2 us. At the company shape the time is mostly the launch and the chain
// of dependent loads (id, then row) of a grid of less than one wave.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 16;        // (b, k) pairs a warp copies: lanes 0..15 load their ids
constexpr int kBatch = 4;         // pieces a lane loads before it stores any
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// The 16-byte bf16 piece at element offset src of the table (8 values).
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* table, int64_t src) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(table + src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(table + src + 4));
    return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                      pack_bf16x2(b.z, b.w));
  } else {
    return __ldg(reinterpret_cast<const uint4*>(table + src));
  }
}

// T is float or __nv_bfloat16; pieces = d / 8 (16-byte bf16 pieces a row),
// log2_pieces its log2 when a power of two, else -1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
onehot_lookup_kernel(const T* __restrict__ table, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ tile_feature, __nv_bfloat16* __restrict__ out,
                     int n_pairs, int k, int d, int total_rows, int pieces, int log2_pieces) {
  const int lane = threadIdx.x % 32;
  const int base = (blockIdx.x * kWarps + threadIdx.x / 32) * kPairs;  // the warp's first pair
  const int pair = base + lane;
  const int row = lane < kPairs && pair < n_pairs ? __ldg(rows + pair) : -1;
  const bool in_block = row >= 0 && row < total_rows && __ldg(tile_feature + row / kTileRows) == pair % k;
  const int my_row = in_block ? row : -1;  // the row lane `pair - base` copies, -1: zeros

  // the warp's output: kPairs pairs of d bf16, contiguous; piece q of it is
  // pair q / pieces, piece q % pieces of that pair
  __nv_bfloat16* dst = out + static_cast<int64_t>(base) * d;
  const int n_pieces = kPairs * pieces;
  for (int q0 = 0; q0 < n_pieces; q0 += 32 * kBatch) {  // the same trip count in every lane: shuffles inside
    uint4 v[kBatch];
    int64_t at[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + 32 * j + lane;
      const int p = log2_pieces >= 0 ? q >> log2_pieces : q / pieces;  // pair in the warp's run
      const int r = __shfl_sync(kFull, my_row, p & 31);
      at[j] = -1;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (q < n_pieces && base + p < n_pairs) {
        at[j] = static_cast<int64_t>(q) * 8;
        // an offset, not a pointer: table + src is formed only for an in-block row
        if (r >= 0) v[j] = load_piece(table, static_cast<int64_t>(r) * d + (q - p * pieces) * 8);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (at[j] >= 0) *reinterpret_cast<uint4*>(dst + at[j]) = v[j];
    }
  }
}

template <typename T>
int launch(const void* table, const void* rows, const void* tile_feature, void* out, long long n_pairs,
           int k, int d, int total_rows, void* stream) {
  if (n_pairs <= 0) return 0;
  if (n_pairs >= (1ll << 31) - 32 || d % 8 || k <= 0 || total_rows % kTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pieces = d / 8;
  const int log2_pieces = (pieces & (pieces - 1)) == 0 ? __builtin_ctz(pieces) : -1;
  const int n = static_cast<int>(n_pairs);
  const int blocks = (n + kWarps * kPairs - 1) / (kWarps * kPairs);
  auto s = static_cast<cudaStream_t>(stream);
  onehot_lookup_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(rows), static_cast<const int32_t*>(tile_feature),
      static_cast<__nv_bfloat16*>(out), n, k, d, total_rows, pieces, log2_pieces);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [total_rows, d] f32, rows [n_pairs / k, k] i32, tile_feature
// [total_rows / 128] i32, out [n_pairs / k, k, d] bf16; d % 8 == 0,
// n_pairs < 2^31 - 32 and table/out 16-byte aligned (the wrapper checks).
int onehot_lookup_f32(const void* table, const void* rows, const void* tile_feature, void* out,
                      long long n_pairs, int k, int d, int total_rows, void* stream) {
  return launch<float>(table, rows, tile_feature, out, n_pairs, k, d, total_rows, stream);
}

// The same with a bf16 table: rows are copied bit for bit.
int onehot_lookup_bf16(const void* table, const void* rows, const void* tile_feature, void* out,
                       long long n_pairs, int k, int d, int total_rows, void* stream) {
  return launch<__nv_bfloat16>(table, rows, tile_feature, out, n_pairs, k, d, total_rows,
                               stream);
}

const char* onehot_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
