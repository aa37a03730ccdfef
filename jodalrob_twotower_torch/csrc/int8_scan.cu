// The int8 index scan's product for Hopper (sm_90a): int8_scan.
//
// Replaces no TPU kernel. The reference scores an int8 chunk with
// jnp.dot(bf16(q), values.T.astype(bf16), preferred_element_type=f32) *
// scales (jodalrob_twotower_tpu/serving/index.py, Int8Index) and leaves the
// int8 -> bf16 convert to XLA, which fuses it into the matmul. The port
// widened each chunk to float32 in device memory, multiplied on the CUDA
// cores (float32, TF32 off) and scaled the block in a third pass.
//
// Function: S[q, c] = scale[c] * sum_d bf16(q[q, d]) * v[c, d] in float32,
// for the bf16 queries [Q, D], the int8 rows [C, D] and the float32 row
// scales [C], into the [Q, C] float32 block out (row stride ld). An int8
// value and a bf16 query are exact in bf16 and their product exact in
// float32, so the kernel forms the float32 products the widened GEMM forms;
// only the order of the float32 sum differs. That order depends on D alone
// (the K tiles in order, the query tile's width a function of D), never on
// Q, C, the row's place in a tile or the tile's place in the launch: a row
// scores the same bits at any offset.
//
// Bound: bytes. A [256, 262,144] chunk at D = 128 reads 33.5 MB of int8
// rows, 1 MB of scales and 64 kB of queries, and writes the 268 MB block
// the top-k reads: 303 MB, 0.0905 ms at 3.35 TB/s. Its 17.2 GFLOP take
// 0.017 ms at the bf16 peak. The write is 89% of the bytes, so the design is
// about keeping the write stream full.
//
// Design. A persistent CTA per SM (per query tile) of two warpgroups. The
// CTA puts its query tile [NQ, D] into shared memory once, bf16 in the
// 128-byte swizzle, as wgmma's B operand: NQ is 256 up to D = 128, 128 up
// to 512, 64 up to 1024, multiplied in two halves of NQ / 2 (one wgmma's N).
// Each warpgroup walks 64-row tiles of the corpus (wgmma's M), the
// warpgroups of the launch interleaved, in steps of two 64-deep K tiles. A
// thread loads 16 bytes of each of its two rows straight into registers,
// two steps ahead (every byte read once), widens them there to bf16 (int8
// -> float by a byte permute into 2^23 + 128 + x less that constant, exact;
// the float's high half is then the exact bf16) and writes them into the
// warpgroup's A tile in shared memory. Each half's wgmma m64nNk16 steps
// accumulate in float32 registers; while the products of one half run, the
// other half goes out: the last tile's second half while this tile's first
// multiplies, this tile's first while its second multiplies. A half goes
// out scaled by its rows' scales, staged transposed in shared memory as two
// [N, 32] boxes in the 128-byte swizzle (conflict-free), then read back 16
// bytes a lane into full 128-byte lines of the row-major block (a warp four
// lines a store; ragged edges masked). Depth is zero-filled past D on both
// operands: zero products leave sums unchanged.
//
// Measured on the H100 (a serving chunk, bound 0.0905 ms): 0.128 ms, where
// a plain 268 MB fill takes 0.086. Designs that ran slower: one
// accumulator a warpgroup (0.130; 0.108 with its int8 loads taken out), TMA
// stores of the staged boxes (0.136), 16-byte stores of scores transposed
// in registers (0.146), and the queries as wgmma's M with whole lines
// exchanged between lanes (0.132; ptxas serializes its wgmma).
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 64;       // corpus rows a warpgroup's tile: wgmma's M
constexpr int kKTile = 64;      // depth a K tile: one 128-byte swizzled bf16 row
constexpr int kGroup = 2;       // K tiles a step widens and multiplies
constexpr int kBoxRows = 32;    // corpus rows a staged box: 128 bytes of float32, the swizzle's width
constexpr int kMaxD = 1024;
constexpr int kATileBytes = kRows * kKTile * 2;  // one K tile of a warpgroup's widened rows

// the query tile's width at a padded depth (each half is one wgmma's N):
// the tile, both warpgroups' widened rows and staging fit in shared memory
__host__ __device__ constexpr int query_tile(int d_pad) { return d_pad <= 128 ? 256 : d_pad <= 512 ? 128 : 64; }

__host__ __device__ constexpr int smem_bytes(int nq, int d_pad) {
  return 1024 + nq * d_pad * 2 + 2 * kGroup * kATileBytes + 2 * (nq / 2) * kRows * 4;
}

// a byte offset in a tile of 128-byte rows in the 128-byte swizzle: row r, 16-byte chunk c
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// four int8 (one 32-bit word) -> two bf16x2: (byte 0, byte 1), (byte 2, byte 3)
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // each byte x + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 16 bytes of row `row` from depth d0: zeros past the rows or the depth
__device__ __forceinline__ uint4 load_piece(const int8_t* __restrict__ values, int64_t row, int n_c, int d, int d0,
                                            bool vec) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (row >= n_c || d0 >= d) return out;
  const int8_t* src = values + row * d + d0;
  if (vec) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(out.x), "=r"(out.y), "=r"(out.z), "=r"(out.w)
                 : "l"(src));
    return out;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (d0 + j < d) w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j))) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc (+)= A (a warpgroup's 64 rows) x B (NH queries), one 16-deep step
template <int NH>
__device__ __forceinline__ void mma(float (&acc)[NH / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (NH == 128) {
    wgmma::mma_ss_m64n128k16<0>(acc, a, b, scale_d);
  } else if constexpr (NH == 64) {
    wgmma::mma_ss_m64n64k16<0>(acc, a, b, scale_d);
  } else {
    wgmma::mma_ss_m64n32k16<0>(acc, a, b, scale_d);
  }
}

// One step's int8 pieces and, for a tile's first step, its row scales.
struct Raw {
  uint4 v[kGroup][2];
  float sc[2];
};

// q bf16 [n_q, d] (as its bits), values int8 [n_c, d], scales f32 [n_c]
// -> out f32 [n_q, n_c], row stride ld. Grid (CTAs a query tile, query
// tiles); CTA x takes the pairs of row tiles x, x + CTAs, ..., a tile a
// warpgroup. A warpgroup's steps run over its tiles and, within a tile,
// over groups of two K tiles.
template <int NQ>
__global__ void __launch_bounds__(kThreads, 1)
int8_scan_kernel(const uint16_t* __restrict__ q, const int8_t* __restrict__ values, const float* __restrict__ scales,
                 float* __restrict__ out, long long ld, int n_q, int n_c, int d, int n_kt, int vec_rows, int vec_q) {
  constexpr int NH = NQ / 2;  // queries a half: one wgmma's N
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wgmma::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* q_tile = smem;                                                  // n_kt K tiles of [NQ, 64] bf16
  uint8_t* a_tile = smem + n_kt * NQ * 128 + wg * kGroup * kATileBytes;    // this warpgroup's rows, kGroup K tiles
  uint8_t* stage = smem + n_kt * NQ * 128 + 2 * kGroup * kATileBytes + wg * NH * kRows * 4;  // two [NH, 32] boxes
  uint8_t* box = stage + (warp >> 1) * NH * 128;  // the box of this warp's rows
  const int q0 = blockIdx.y * NQ;
  const int n_groups = (n_kt + kGroup - 1) / kGroup;
  const int n_pairs = (n_c + 2 * kRows - 1) / (2 * kRows);
  const int my_pairs = static_cast<int>(blockIdx.x) < n_pairs ? (n_pairs - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int n_steps = my_pairs * n_groups;
  const int r_lo = warp * 16 + g;  // this thread's rows of a tile: r_lo and r_lo + 8
  const int box_bar = 1 + 2 * wg + (warp >> 1);  // a box's two warps
  const int wg_bar = 5 + wg;

  // step s: tile 2 (x + (s / groups) CTAs) + wg, K tiles of group s % groups;
  // past the CTA's last step a tile past the rows, which loads zeros and stores nothing
  auto tile_of = [&](int s) { return 2 * (static_cast<int>(blockIdx.x) + (s / n_groups) * static_cast<int>(gridDim.x)) + wg; };
  auto load = [&](Raw& raw, int s) {
    const int tile = tile_of(s), grp = s % n_groups;
#pragma unroll
    for (int kg = 0; kg < kGroup; ++kg) {
      const int kt = grp * kGroup + kg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        raw.v[kg][h] = kt < n_kt ? load_piece(values, static_cast<int64_t>(tile) * kRows + r_lo + 8 * h, n_c, d,
                                              kt * kKTile + 16 * t, vec_rows)
                                 : make_uint4(0, 0, 0, 0);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile * kRows + r_lo + 8 * h;
        raw.sc[h] = row < n_c ? __ldg(scales + row) : 0.f;
      }
    }
  };

  Raw raw_a, raw_b;
  load(raw_a, 0);
  load(raw_b, 1);

  // the query tile: bf16 q[q0 + n, dd] at K tile dd / 64, row n, column
  // dd % 64; zeros past the queries and the depth
  const int pieces = n_kt * (kKTile / 8);
  for (int p = tid; p < NQ * pieces; p += kThreads) {
    const int n = p / pieces, d0 = (p % pieces) * 8, row = q0 + n;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (vec_q && row < n_q && d0 < d) {
      v = __ldg(reinterpret_cast<const uint4*>(q + static_cast<int64_t>(row) * d + d0));
    } else if (row < n_q) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (d0 + j < d) w[j >> 1] |= static_cast<uint32_t>(__ldg(q + static_cast<int64_t>(row) * d + d0 + j)) << (16 * (j & 1));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(q_tile + (d0 / kKTile) * NQ * 128 + swz(n, (d0 % kKTile) / 8)) = v;
  }
  wgmma::fence_proxy_async();
  __syncthreads();

  // staging of a half's [NH, 64] scores: warp w's rows are box w / 2, rows
  // 16 (w % 2) + g (+ 8) of it; score (query qq, box row rr) at
  // qq * 128 + ((rr / 4 ^ qq % 8) * 16) + (rr % 4) * 4: conflict-free
  uint32_t st_off[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rr = 16 * (warp & 1) + g + 8 * h, qq = 2 * t + j;
      st_off[h][j] = qq * 128 + ((((rr >> 2) ^ qq) & 7) << 4) + (rr & 3) * 4;
    }
  }
  // one half's scores of tile rt, scaled, to the block: staged, then read
  // back 16 bytes a lane, eight lanes a query's 128-byte row, a warp four
  // full lines a store
  auto epilogue = [&](const float (&acc)[NH / 2], const float (&sc)[2], int rt, int half) {
    wgmma::named_barrier_sync(box_bar, 64);  // the box's last read-back is done
#pragma unroll
    for (int i = 0; i < NH / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<float*>(box + st_off[h][j] + i * 1024) = acc[4 * i + 2 * h + j] * sc[h];
        }
      }
    }
    wgmma::named_barrier_sync(box_bar, 64);
    const int col0 = rt * kRows + (warp >> 1) * kBoxRows;
#pragma unroll 4
    for (int p = tid & 63; p < NH * 8; p += 64) {
      const int qq = p / 8, c = p % 8;
      const float4 val = *reinterpret_cast<const float4*>(box + swz(qq, c));
      const int row = q0 + half * NH + qq, col = col0 + c * 4;
      if (row < n_q) {
        float* dst = out + row * ld + col;
        if (col + 3 < n_c) {
          asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(val.x), "f"(val.y), "f"(val.z),
                       "f"(val.w)
                       : "memory");
        } else {
          const float e[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (col + k < n_c) dst[k] = e[k];
          }
        }
      }
    }
  };

  float acc0[NH / 2], acc1[NH / 2];  // the tile's two halves of queries
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc0[i] = acc1[i] = 0.f;
  float sc[2] = {0.f, 0.f}, sc_prev[2] = {0.f, 0.f};
  const uint32_t q_base = wgmma::smem_u32(q_tile), a_base = wgmma::smem_u32(a_tile);

  // A step: widen its rows into the A tile, start loading the step two on,
  // multiply half 0 while the last tile's half 1 goes out, then half 1
  // while this tile's half 0 goes out (at a tile's last step).
  auto step = [&](Raw& raw, int s) {
    const int rt = tile_of(s), grp = s % n_groups;
    wgmma::wait<0>();  // the last step's products have read the A tile
    wgmma::fence_operand(acc0);
    wgmma::fence_operand(acc1);
#pragma unroll
    for (int kg = 0; kg < kGroup; ++kg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w[4] = {raw.v[kg][h].x, raw.v[kg][h].y, raw.v[kg][h].z, raw.v[kg][h].w};
        uint32_t b[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) widen(w[k], b[2 * k], b[2 * k + 1]);
        uint8_t* row = a_tile + kg * kATileBytes;
        *reinterpret_cast<uint4*>(row + swz(r_lo + 8 * h, 2 * t)) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(row + swz(r_lo + 8 * h, 2 * t + 1)) = make_uint4(b[4], b[5], b[6], b[7]);
      }
    }
    if (grp == 0) {
      sc_prev[0] = sc[0];
      sc_prev[1] = sc[1];
      sc[0] = raw.sc[0];
      sc[1] = raw.sc[1];
    }
    wgmma::fence_proxy_async();
    wgmma::named_barrier_sync(wg_bar, 128);  // the warpgroup's rows are in place
    load(raw, s + 2);

    // a K tile past the depth multiplies zero rows by the last K tile's
    // finite queries: it adds zeros, and keeps the issue uniform
    auto issue = [&](float (&acc)[NH / 2], int half) {
#pragma unroll
      for (int kg = 0; kg < kGroup; ++kg) {
        const int kt = min(grp * kGroup + kg, n_kt - 1);
#pragma unroll
        for (int k = 0; k < kKTile / 16; ++k) {
          const uint64_t a = wgmma::desc_sw128(a_base + kg * kATileBytes + k * 32, 16, 1024);
          const uint64_t b = wgmma::desc_sw128(q_base + kt * NQ * 128 + half * NH * 128 + k * 32, 16, 1024);
          mma<NH>(acc, a, b, grp > 0 || kg > 0 || k > 0);
        }
      }
      wgmma::commit();
    };
    wgmma::fence();
    issue(acc0, 0);
    if (grp == 0 && s > 0) epilogue(acc1, sc_prev, tile_of(s - 1), 1);  // the last tile's half 1, its products done
    wgmma::fence_operand(acc1);
    wgmma::fence();
    issue(acc1, 1);
    wgmma::wait<1>();  // half 0's products are done
    wgmma::fence_operand(acc0);
    if (grp == n_groups - 1) epilogue(acc0, sc, rt, 0);
  };

  for (int s = 0; s < n_steps; s += 2) {
    step(raw_a, s);
    step(raw_b, s + 1);
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc1);
  if (n_steps > 0) epilogue(acc1, sc, tile_of(n_steps + (n_steps & 1) - 1), 1);
}

template <int NQ>
cudaError_t launch(const void* q, const void* values, const void* scales, void* out, int n_q, int n_c, int d,
                   long long ld, cudaStream_t stream) {
  const int n_kt = (d + kKTile - 1) / kKTile;
  const int smem = smem_bytes(NQ, n_kt * kKTile);
  cudaError_t err = cudaFuncSetAttribute(int8_scan_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (n_q + NQ - 1) / NQ;
  const int n_pairs = (n_c + 2 * kRows - 1) / (2 * kRows);
  int per_qt = sms / n_qt;  // CTAs a query tile: the SMs shared out, at most one a tile pair
  if (per_qt > n_pairs) per_qt = n_pairs;
  if (per_qt < 1) per_qt = 1;
  const int vec_rows = d % 16 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0;
  const int vec_q = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int8_scan_kernel<NQ><<<dim3(per_qt, n_qt), kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<float*>(out), ld, n_q, n_c, d, n_kt, vec_rows, vec_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q bf16 [n_q, d], values int8 [n_c, d], scales f32 [n_c], all contiguous;
// out f32 [n_q, n_c] with row stride ld (a multiple of 4, at least n_c),
// 16-byte aligned. d in [1, 1024].
int int8_scan(const void* q, const void* values, const void* scales, void* out, int n_q, int n_c, int d,
              long long ld, void* stream) {
  if (n_q < 1 || n_c < 1 || d < 1 || d > kMaxD || ld < n_c || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (query_tile((d + kKTile - 1) / kKTile * kKTile)) {
    case 256:
      return static_cast<int>(launch<256>(q, values, scales, out, n_q, n_c, d, ld, s));
    case 128:
      return static_cast<int>(launch<128>(q, values, scales, out, n_q, n_c, d, ld, s));
    default:
      return static_cast<int>(launch<64>(q, values, scales, out, n_q, n_c, d, ld, s));
  }
}

int int8_scan_max_d() { return kMaxD; }

// the kernel's dynamic shared memory at depth d
int int8_scan_smem_bytes(int d) {
  const int d_pad = (d + kKTile - 1) / kKTile * kKTile;
  return smem_bytes(query_tile(d_pad), d_pad);
}

const char* int8_scan_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
