// Row gather of an embedding table for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel jodalrob_twotower_tpu/ops/embedding_lookup.py:46
// `_gather_kernel` (called through `_pallas_gather_flat` and
// `embedding_lookup_pallas`), in two forms of one kernel:
//
//   clamp         out[i, :] = table[clamp(ids[i], 0, R - 1), :], XLA's
//                 clamping gather (`jnp.take(..., mode="clip")`): the TPU
//                 kernel's function. The port's callers pass rows already
//                 clamped per feature (models/embedding.py).
//   zero_outside  `table` is the block [R, D] of a row-sharded table whose
//                 first global row is `offset`: out[i, :] = table[ids[i] -
//                 offset, :] where offset <= ids[i] < offset + R, else zero
//                 bits, and the table is not read for that row. This is the
//                 reference's masked gather of a mesh rank
//                 (jodalrob_twotower_tpu/parallel/sharded_embedding.py:251-257,
//                 `jnp.where(in_range, jnp.take(t_shard, clip(local)), 0)`)
//                 in one launch.
//
// Rows of the table's own dtype (f32 or bf16) move as 16-byte pieces, so
// the output is the table's bits. Ids are int32 or int64, each read at its
// own width (a template argument): an int64 id at or above 2^31 clamps (or
// falls outside the block) as its value says. Offsets are 64-bit: the
// 10,000,384 x 64 f32 table of BASELINE config 3 is 2.56 GB.
//
// Bound: bytes. The ids are read once, each distinct row the function
// reads is read once (in the zero form only the rows inside the block),
// and the output is written once. At 65,536 ids of the [10,000,384, 64]
// f32 table (the scaled_dense path) that is 0.26 + 16.8 + 16.8 MB, 0.0101
// ms at 3.35 TB/s; in bf16 0.0051; a ragged batch of 8,000 ids 0.0012; on
// rank 1's block [5,000,192, 64] of the f32 table, half the ids inside
// (the mesh_scaled_dense path), 0.0076.
//
// What held the first form (one piece per thread) back, and what this
// design does about each point:
//   1. One 16-byte piece per thread, behind a dependent id load: 1M
//      threads in 4,096 blocks at 65,536 ids, each thread loading its
//      row's id (the same address for the 16 threads of a row) and only
//      then its piece. Here a warp takes a chunk of rows (8 at 256-byte
//      rows, 16 at 128-byte rows: 128 pieces), loads the chunk's ids first
//      in one coalesced load (lane r holds row r's), turns each into a
//      source row, and hands them to the lanes with __shfl_sync; every
//      thread then issues 4 independent 16-byte loads (64 bytes in flight)
//      before its first store. The grid is one wave of blocks at the
//      kernel's occupancy; past it a warp walks further chunks with the
//      next chunk's ids already in flight. The table is read with
//      ld.global.nc.L1::no_allocate (each row is read once); the output
//      keeps the default store policy, since it fits the 50 MB L2 and the
//      tower or the reduce-scatter reads it next.
//   2. The clamp made a hot row on a rank's block: every id outside the
//      block was clamped to its edge row (half of the 65,536 ids onto one
//      256-byte row on rank 1 of 2), read, then zeroed. The zero form reads
//      no row for such an id.
//   3. Work around the launch: the ids' offset, two compares, the clamp,
//      an int32 cast and a masked fill over [65,536, 64] f32 ran as small
//      kernels beside K4 (0.032 of the masked gather's 0.051 ms). The zero
//      form computes in-range with one unsigned compare of ids[i] - offset
//      and writes the zero rows itself; int64 ids need no cast.
// On the H100 (PERF.md, section 6) the masked gather went from 0.050-0.059 ms
// to 0.016, and the clamp form moved by -9% to +1.5% at its shapes. Timed
// after an L2 flush, as the smoke times every kernel, K4 sits about 0.0058
// ms (a launch of one id) plus the write-back of the flush's dirty lines
// (about 0.004 ms at the f32 shape) above its bound; the gather itself
// runs near the memory rate. A form with Hopper's one-dimensional bulk
// copies (cp.async.bulk rows into shared memory on an mbarrier, one bulk
// store a chunk) was timed beside this one and was slower at every shape
// but the masked gather (2% faster there, 20% slower on clamped hot rows),
// so it is not kept.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                 // 16-byte pieces a thread has in flight per pass
constexpr int kPassPieces = 32 * kSlots;  // pieces a warp moves per pass
constexpr int kMaxDevices = 64;

// A row piece read once: through the non-coherent path, no L1 line.
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// A warp's chunk is `chunk_rows` consecutive ids (<= 32, so lane r holds
// row r's id) and their rows: chunk_rows * pieces 16-byte pieces, moved in
// passes of 128 (one pass unless a row is longer than 2 KB, chunk_rows 1);
// in a pass lane l moves pieces l, l + 32, l + 64 and l + 96.
// `pieces_shift` is log2(pieces) when pieces is a power of two, else -1.
template <typename Id, bool kZeroOutside>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ table, const Id* __restrict__ ids, uint4* __restrict__ out,
                  int64_t n, int64_t n_chunks, int pieces, int pieces_shift, int chunk_rows, int64_t table_rows,
                  int64_t offset) {
  const int lane = threadIdx.x & 31;
  int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // the first chunk's ids before anything else
  Id next = 0;
  if (chunk < n_chunks && lane < chunk_rows && chunk * chunk_rows + lane < n) next = ids[chunk * chunk_rows + lane];
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (; chunk < n_chunks; chunk += n_warps) {
    const Id id = next;
    const int64_t row0 = chunk * chunk_rows;
    const int chunk_pieces = static_cast<int>(n - row0 < chunk_rows ? n - row0 : chunk_rows) * pieces;
    const int64_t after = chunk + n_warps;  // the warp's next chunk: its ids in flight with this chunk's rows
    next = after < n_chunks && lane < chunk_rows && after * chunk_rows + lane < n ? ids[after * chunk_rows + lane]
                                                                                  : Id(0);
    // this lane's row of the chunk: its source row, or -1 for a row of zeros
    int64_t src;
    if (kZeroOutside) {
      const uint64_t local = static_cast<uint64_t>(static_cast<int64_t>(id)) - static_cast<uint64_t>(offset);
      src = local < static_cast<uint64_t>(table_rows) ? static_cast<int64_t>(local) : -1;
    } else {
      const int64_t r = static_cast<int64_t>(id);
      src = r < 0 ? 0 : (r >= table_rows ? table_rows - 1 : r);
    }
    uint4* const chunk_out = out + row0 * pieces;
    for (int pass = 0; pass < chunk_pieces; pass += kPassPieces) {
      uint4 v[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int f = pass + k * 32 + lane;
        const int row = pieces_shift >= 0 ? f >> pieces_shift : f / pieces;
        const int64_t s = __shfl_sync(0xffffffffu, src, row & 31);
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (f < chunk_pieces && s >= 0) v[k] = load_once(table + s * pieces + (f - row * pieces));
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (pass + k * 32 + lane < chunk_pieces) chunk_out[pass + k * 32 + lane] = v[k];
      }
    }
  }
}

// Blocks of one wave at the kernel's occupancy on the current device,
// asked once per device.
template <typename Id, bool kZeroOutside>
int wave_blocks() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel<Id, kZeroOutside>, kThreads, 0) !=
        cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

template <typename Id, bool kZeroOutside>
int launch(const void* table, const void* ids, void* out, int64_t n, int pieces, int64_t table_rows, int64_t offset,
           cudaStream_t stream) {
  const int chunk_rows = pieces >= kPassPieces ? 1 : (kPassPieces / pieces < 32 ? kPassPieces / pieces : 32);
  const int pieces_shift = (pieces & (pieces - 1)) ? -1 : __builtin_ctz(static_cast<unsigned>(pieces));
  const int64_t chunks = (n + chunk_rows - 1) / chunk_rows;
  const int64_t wanted = (chunks + kWarps - 1) / kWarps;
  const int wave = wave_blocks<Id, kZeroOutside>();
  if (!wave) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const unsigned grid = static_cast<unsigned>(wanted < wave ? wanted : wave);
  row_gather_kernel<Id, kZeroOutside><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(table), static_cast<const Id*>(ids), static_cast<uint4*>(out), n, chunks, pieces,
      pieces_shift, chunk_rows, table_rows, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [table_rows, row_bytes / elem] (any dtype), ids [n] of id_bytes (4:
// int32, 8: int64) -> out [n, row_bytes / elem] in the table's dtype.
// zero_outside 0: the clamp form (offset must be 0); 1: the zero form over
// the block whose first global row is offset (>= 0). row_bytes a multiple
// of 16, table and out 16-byte aligned (the wrapper checks).
int row_gather(const void* table, const void* ids, void* out, long long n, int row_bytes, long long table_rows,
               int id_bytes, long long offset, int zero_outside, void* stream) {
  if (n < 0 || row_bytes <= 0 || row_bytes % 16 || table_rows <= 0 || offset < 0 ||
      (id_bytes != 4 && id_bytes != 8) || (zero_outside != 0 && zero_outside != 1) || (!zero_outside && offset)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int pieces = row_bytes / 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) {
    return zero_outside ? launch<int32_t, true>(table, ids, out, n, pieces, table_rows, offset, s)
                        : launch<int32_t, false>(table, ids, out, n, pieces, table_rows, offset, s);
  }
  return zero_outside ? launch<int64_t, true>(table, ids, out, n, pieces, table_rows, offset, s)
                      : launch<int64_t, false>(table, ids, out, n, pieces, table_rows, offset, s);
}

const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
