// Row gather of the unified embedding table for Hopper (sm_90a).
//
// Replaces the TPU kernel jodalrob_twotower_tpu/ops/embedding_lookup.py:46
// `_gather_kernel` (called through `_pallas_gather_flat` and
// `embedding_lookup_pallas`): out[i, :] = table[rows[i], :] in the table's
// own dtype (f32 or bf16), for n rows of any count.
//
// A row outside [0, R) is clamped to the nearest edge row (0 or R - 1), as
// XLA's gather clamps its start indices: the kernel reads no memory outside
// the table. The port's callers pass rows already clamped per feature
// (models/embedding.py), so the clamp never changes a row on their paths.
//
// Design. The TPU kernel kept 8 row DMAs in flight per program because each
// HBM->VMEM copy of one row was a separate descriptor. On Hopper a row is
// D * 4 bytes (256 at D = 64 f32): each thread moves one 16-byte piece, so
// neighbouring threads read neighbouring addresses of a row and write
// neighbouring addresses of the output; a warp covers two rows at D = 64
// f32, and the whole grid keeps every piece of every row in flight at once.
// The TPU's padding to 256 ids per program has no counterpart: the last
// block masks its tail. Offsets are 64-bit: the 10,000,384 x 64 f32 table
// is 2.56 GB, past 2^31 bytes.
//
// Bound: bytes. The ids (4 bytes each) and each referenced table row are
// read once and the output written once: at B * K = 65,536 ids of a
// [10,000,384, 64] f32 table, 0.26 + 16.8 + 16.8 MB, about 0.010 ms at
// 3.35 TB/s. Random rows touch one 256-byte stretch each, a whole number of
// 32-byte sectors, so no sector is read for nothing.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ rows,
                  uint4* __restrict__ out, int64_t n_pieces, int pieces_per_row,
                  int64_t total_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_pieces;
       i += stride) {
    const int64_t row = i / pieces_per_row;
    const int piece = static_cast<int>(i - row * pieces_per_row);
    int64_t r = __ldg(rows + row);
    r = r < 0 ? 0 : (r >= total_rows ? total_rows - 1 : r);
    out[i] = __ldg(table + r * pieces_per_row + piece);
  }
}

}  // namespace

extern "C" {

// table [total_rows, row_bytes / elem] (any dtype), rows [n] i32 -> out
// [n, row_bytes / elem] in the table's dtype. row_bytes a multiple of 16,
// table and out 16-byte aligned (the wrapper checks).
int row_gather(const void* table, const void* rows, void* out, long long n, int row_bytes,
               long long total_rows, void* stream) {
  if (n < 0 || row_bytes <= 0 || row_bytes % 16 || total_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int pieces_per_row = row_bytes / 16;
  const int64_t n_pieces = static_cast<int64_t>(n) * pieces_per_row;
  const int64_t blocks = (n_pieces + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1u << 30) ? blocks : (1u << 30));
  row_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(rows), static_cast<uint4*>(out),
      n_pieces, pieces_per_row, total_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
