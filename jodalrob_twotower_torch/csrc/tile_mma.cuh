// Warp-level building blocks shared by the in-batch CE and statistics
// kernels (fused_ce_fwd.cu, fused_ce_bwd.cu, fused_stats.cu): bf16
// tensor-core products with f32 accumulation through mma.sync (m16n8k16),
// ldmatrix, and cp.async tile copies. Fragment layouts are the PTX ISA's for mma.m16n8k16 with .bf16
// operands: for lane l, g = l / 4 and t = l % 4,
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8, f32):        c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column tiles are the A fragment
// of a 16-deep product over those columns.
//
// The embedding width D is any multiple of kChunk = 128. Operands move in
// 128-deep chunks: a warp holds its rows' fragments of one chunk (32
// registers a lane), and a shared tile holds one chunk of 64 rows, so
// registers and shared memory do not grow with D.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_mma {

constexpr int kChunk = 128;             // depth of one operand chunk
constexpr int kChunkSteps = kChunk / 16;  // mma depth steps per chunk
constexpr int kChunkLd = kChunk + 8;    // shared row stride (bf16): 272 bytes, conflict-free fragments

// c += a * b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on the way: lane l gives the row address
// of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// two f32 values -> bf16x2, round to nearest even; lo is the lower column
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One chunk, [kRows, 128], of a row-major bf16 matrix with row stride d
// (src points at the chunk's first element) into shared memory with row
// stride kChunkLd, 16 bytes per cp.async, spread over kThreads threads.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_chunk_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                 int d, int tid) {
  constexpr int kPerRow = kChunk / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < kRows * kPerRow / kThreads; ++i) {
    const int q = tid + i * kThreads;
    const int r = q / kPerRow, p = q % kPerRow;
    cp_async_16(dst + r * kChunkLd + p * 8, src + static_cast<int64_t>(r) * d + p * 8);
  }
}

// The A fragments of rows ra and ra + 8 (this lane's rows of a 16-row warp
// tile) of a row-major [*, d] bf16 matrix, over depth chunk0 .. chunk0 + 127.
__device__ __forceinline__ void load_row_fragments(uint32_t (&a)[kChunkSteps][4],
                                                   const __nv_bfloat16* m, int ra, int t, int d,
                                                   int chunk0) {
#pragma unroll
  for (int ks = 0; ks < kChunkSteps; ++ks) {
    const __nv_bfloat16* p = m + static_cast<int64_t>(ra) * d + chunk0 + ks * 16 + 2 * t;
    a[ks][0] = load_u32(p);
    a[ks][1] = load_u32(p + static_cast<int64_t>(8) * d);
    a[ks][2] = load_u32(p + 8);
    a[ks][3] = load_u32(p + static_cast<int64_t>(8) * d + 8);
  }
}

template <int kNSub>
__device__ __forceinline__ void zero_scores(float (&s)[kNSub][4]) {
#pragma unroll
  for (int ns = 0; ns < kNSub; ++ns) s[ns][0] = s[ns][1] = s[ns][2] = s[ns][3] = 0.f;
}

// s += the warp's 16 rows (fragments a of one depth chunk) against the
// 8 * kNSub rows of a shared chunk tile ct, in f32: s[ns] holds columns
// ns * 8 .. ns * 8 + 7 in the C layout above. Every S value of every kernel
// that includes this header comes from zero_scores and then one call per
// chunk in chunk order (the depth steps 0, 1, ..., D/16 - 1 in order), so
// equal operands in equal fragment positions give equal bits at every D.
template <int kNSub>
__device__ __forceinline__ void chunk_scores(float (&s)[kNSub][4],
                                             const uint32_t (&a)[kChunkSteps][4],
                                             const __nv_bfloat16* ct, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kChunkSteps; ++ks) {
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
      const __nv_bfloat16* bp = ct + (ns * 8 + g) * kChunkLd + ks * 16 + 2 * t;
      mma_bf16_16816(s[ns], a[ks], load_u32(bp), load_u32(bp + 8));
    }
  }
}

}  // namespace tile_mma
