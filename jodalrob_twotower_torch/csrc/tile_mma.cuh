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

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_mma {

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

// A [kRows, kD] tile of a row-major [*, kD] bf16 matrix into shared memory
// with row stride kLd, 16 bytes per cp.async, spread over kThreads threads.
template <int kD, int kRows, int kLd, int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int tid) {
  constexpr int kPerRow = kD / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < kRows * kPerRow / kThreads; ++i) {
    const int q = tid + i * kThreads;
    const int r = q / kPerRow, p = q % kPerRow;
    cp_async_16(dst + r * kLd + p * 8, src + static_cast<int64_t>(r) * kD + p * 8);
  }
}

// The A fragments of rows ra and ra + 8 (this lane's rows of a 16-row warp
// tile) of a row-major [*, kD] bf16 matrix, over all of kD.
template <int kD>
__device__ __forceinline__ void load_row_fragments(uint32_t (&a)[kD / 16][4],
                                                   const __nv_bfloat16* m, int ra, int t) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* p = m + static_cast<int64_t>(ra) * kD + ks * 16 + 2 * t;
    a[ks][0] = load_u32(p);
    a[ks][1] = load_u32(p + 8 * kD);
    a[ks][2] = load_u32(p + 8);
    a[ks][3] = load_u32(p + 8 * kD + 8);
  }
}

// s = the warp's 16 rows (fragments a) against the 8 * kNSub rows of a
// shared [*, kLd] tile ct, in f32: s[ns] holds columns ns * 8 .. ns * 8 + 7
// in the C layout above. Every S value of every kernel that includes this
// header comes from this one sequence (zero, then depth steps 0, 1, ... in
// order), so equal operands in equal fragment positions give equal bits.
template <int kD, int kNSub, int kLd>
__device__ __forceinline__ void tile_scores(float (&s)[kNSub][4], const uint32_t (&a)[kD / 16][4],
                                            const __nv_bfloat16* ct, int g, int t) {
#pragma unroll
  for (int ns = 0; ns < kNSub; ++ns) s[ns][0] = s[ns][1] = s[ns][2] = s[ns][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
      const __nv_bfloat16* bp = ct + (ns * 8 + g) * kLd + ks * 16 + 2 * t;
      mma_bf16_16816(s[ns], a[ks], load_u32(bp), load_u32(bp + 8));
    }
  }
}

}  // namespace tile_mma
