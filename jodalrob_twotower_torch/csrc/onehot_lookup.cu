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
// because its row DMAs were slow. On Hopper a direct row gather is the right
// form: each thread moves one 16-byte piece of a row (4 f32 values, so a D=32
// f32 row is 8 threads and a warp serves 4 (b, k) pairs; or 8 bf16 values),
// rounds to bf16 with __float2bfloat16_rn (round to nearest even, the
// rounding of the plain version's .to(torch.bfloat16)), and stores straight
// into the tower's [B, K*D] layout: no [K, D, B] transpose.
//
// Bound: bytes. Each (b, k) pair reads its 4-byte id and writes D*2 bytes;
// the table rows the batch references are read once (repeats hit L2). At
// the serving shapes, D=32: a notice query batch (B=1024, K=32, table 32,768
// rows) moves ~6.4 MB, ~2 us at 3.35 TB/s; a company encode chunk (B=8192,
// K=6, 6,144 rows) ~4 MB counting each referenced row once, ~1.2 us.
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// T is float or __nv_bfloat16; one thread per 16-byte piece of an output row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
onehot_lookup_kernel(const T* __restrict__ table, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ tile_feature,
                     __nv_bfloat16* __restrict__ out, int64_t n_pairs, int k, int d,
                     int total_rows) {
  constexpr int kVec = 16 / sizeof(T);  // table values in a 16-byte piece
  const int pieces = d / kVec;          // threads per (b, k) pair
  const int64_t n_pieces = n_pairs * pieces;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_pieces;
       i += stride) {
    const int64_t pair = i / pieces;
    const int piece = static_cast<int>(i - pair * pieces);
    const int feature = static_cast<int>(pair % k);
    const int row = __ldg(rows + pair);
    const bool in_block =
        row >= 0 && row < total_rows && __ldg(tile_feature + row / kTileRows) == feature;
    __nv_bfloat16* dst = out + pair * d + static_cast<int64_t>(piece) * kVec;
    // an offset, not a pointer: table + src is formed only for an in-block row
    const int64_t src = static_cast<int64_t>(row) * d + static_cast<int64_t>(piece) * kVec;
    if constexpr (sizeof(T) == 4) {
      uint2 packed = make_uint2(0u, 0u);
      if (in_block) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(table + src));
        packed.x = pack_bf16x2(v.x, v.y);
        packed.y = pack_bf16x2(v.z, v.w);
      }
      *reinterpret_cast<uint2*>(dst) = packed;
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in_block) v = __ldg(reinterpret_cast<const uint4*>(table + src));
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

template <typename T>
int launch(const void* table, const void* rows, const void* tile_feature, void* out,
           long long n_pairs, int k, int d, int total_rows, void* stream) {
  const int64_t n_pieces = static_cast<int64_t>(n_pairs) * (d / (16 / sizeof(T)));
  if (n_pieces <= 0) return 0;
  const int64_t want = (n_pieces + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  onehot_lookup_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(tile_feature), static_cast<__nv_bfloat16*>(out), n_pairs, k,
      d, total_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [total_rows, d] f32, rows [n_pairs / k, k] i32, tile_feature
// [total_rows / 128] i32, out [n_pairs / k, k, d] bf16; d % 8 == 0 and
// table/out 16-byte aligned (the wrapper checks).
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
