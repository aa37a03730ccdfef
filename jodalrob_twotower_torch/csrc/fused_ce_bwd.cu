// Backward of the bidirectional in-batch CE for Hopper (sm_90a): dN and dC
// without writing S or dL/dS.
//
// Replaces the TPU kernel jodalrob_twotower_tpu/ops/fused_logits.py:819
// `_bwd_kernel` (called through `_fused_bwd_call`). For N [rows, D] (scaled
// by 1/tau) and C [B, D], both bf16, the statistics row_lse [rows] and
// col_lse [B] of the forward, label smoothing eps and the global row index
// row_offset of N's first row (0 on one device):
//
//   A[i, j] = bf16( (1/2B) [ exp(S_ij - row_lse_i) + exp(S_ij - col_lse_j)
//                            - 2 (1 - eps) [j == i + row_offset] - 2 eps / B ] )
//   dn = A C        [rows, D] f32          dc = A^T N        [B, D] f32
//
// A is rounded to bf16 before both products, as on the TPU
// (fused_logits.py:844-846).
//
// Design. The TPU accumulated dc in one output block revisited across a
// sequential grid. On Hopper the two products run as two sweeps in one
// launch (the first blocks of the grid take dn, the rest dc, so both fill
// the card at once), and every output row is summed by one warp in a fixed
// order (no atomics: two calls give the same bits):
//   - the dn sweep: a block owns 64 rows of N and walks the 64-column tiles
//     of C; the dc sweep: a block owns 64 rows of C and walks the tiles of N
//     (S^T = C N^T: the same code with the operands, the two lse vectors and
//     the side of the diagonal swapped);
//   - operands move in 128-deep chunks (tile_mma.cuh): each warp holds its
//     16 rows' bf16 fragments of one chunk, recomputes its S tile over all
//     of D with mma.sync m16n8k16 (f32), forms A in registers, and feeds the
//     C-fragments of A straight back as the A-fragments of the second
//     product, whose operand comes out of the shared chunk tile through
//     ldmatrix.trans;
//   - a warp's [16, D] f32 output would take D / 2 registers a lane (256 at
//     D = 512), so each block computes one 128-wide chunk of it (the grid's
//     y index), which stays in registers for the whole sweep. A block
//     streams a tile's depth chunks starting after its own output chunk, so
//     the last chunk in shared memory is the one the second product reads;
//     above D = 128 each output chunk recomputes S (D / 128 times the S
//     products), and its S sums run in that rotated chunk order. At
//     D = 128 there is one chunk and one order.
//
// Bound: at B = 8192, D = 128 the products are 6 B^2 D = 51.5 GFLOP, 0.052 ms
// at the 989 TFLOP/s bf16 peak (this kernel recomputes S in both sweeps:
// 8 B^2 D in all at D = 128, (4 + 4 D / 128) B^2 D above); the bytes are
// about 8.5 MB. Bound by operations, and below
// the tensor cores by the 2 B^2 exponentials per sweep.
//
// Interface: plain C, loaded with ctypes. The entry point launches both
// sweeps, as one grid, on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

constexpr int kBM = 64;           // rows per block
constexpr int kBN = 64;           // columns per tile
constexpr int kWarps = kBM / 16;  // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kNSub = kBN / 8;    // 8-column tiles of S per column tile
constexpr int kOutSub = kChunk / 8;  // 8-column tiles of a block's [16, 128] output chunk

// Chunk q of the kBN-row column tile j of m [*, d] into shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* m, int j, int q,
                                          int d, int tid) {
  load_chunk_async<kBN, kThreads>(dst, m + static_cast<int64_t>(j) * kBN * d + q * kChunk, d, tid);
}

// One sweep: out[r, :] = sum_c A[r, c] * cols_m[c, :] for the rows r of
// rows_m, over every column c of cols_m. The diagonal term sits at
// c == r + diag_shift; lse_r and lse_c are the statistics of the rows' and
// the columns' own sides.
struct Sweep {
  const __nv_bfloat16* rows_m;
  const __nv_bfloat16* cols_m;
  const float* lse_r;
  const float* lse_c;
  float* out;
  int n_cols;
  int diag_shift;
};

// Blocks [0, dn_blocks) run the dn sweep, the rest the dc sweep; each block
// owns 64 rows of its sweep and output columns blockIdx.y * 128 .. + 127.
__global__ void __launch_bounds__(kThreads)
ce_bwd_sweeps(Sweep dn, Sweep dc, int dn_blocks, int d, float inv2b, float diag_coef,
              float smooth_term) {
  __shared__ __align__(16) __nv_bfloat16 tile[2][kBN * kChunkLd];

  const bool is_dn = static_cast<int>(blockIdx.x) < dn_blocks;
  const Sweep sw = is_dn ? dn : dc;
  const int block = is_dn ? blockIdx.x : blockIdx.x - dn_blocks;
  const __nv_bfloat16* __restrict__ rows_m = sw.rows_m;
  const __nv_bfloat16* __restrict__ cols_m = sw.cols_m;
  const float* __restrict__ lse_r = sw.lse_r;
  const float* __restrict__ lse_c = sw.lse_c;
  float* __restrict__ out = sw.out;
  const int n_cols = sw.n_cols, diag_shift = sw.diag_shift;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = block * kBM + warp * 16 + g;  // this lane's rows: ra and ra + 8

  const int n_chunks = d / kChunk, out_chunk = blockIdx.y;
  // this block's depth order over a tile: out_chunk + 1, ..., n_chunks - 1,
  // 0, ..., out_chunk (a single chunk when D = 128)
  const int first_q = out_chunk + 1 < n_chunks ? out_chunk + 1 : 0;
  uint32_t a[kChunkSteps][4];
  load_row_fragments(a, rows_m, ra, t, d, first_q * kChunk);
  const float lr[2] = {lse_r[ra], lse_r[ra + 8]};

  float acc[kOutSub][4];
#pragma unroll
  for (int o = 0; o < kOutSub; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;

  // ldmatrix row addresses of this lane for the second product: matrix
  // l / 8 covers depth rows (l / 8 % 2) * 8 .. +7 and output columns
  // (l / 16) * 8 .. +7 of a 16 x 16 block
  const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_col = (lane >> 4) * 8;

  // items: (column tile j, k-th chunk of the block's order), k fastest;
  // item i sits in tile[i & 1]
  const int n_tiles = n_cols / kBN;
  const int n_items = n_tiles * n_chunks;
  load_tile(tile[0], cols_m, 0, first_q, d, tid);
  cp_async_commit();
  float s[kNSub][4];
  for (int i = 0, j = 0, k = 0, q = first_q; i < n_items; ++i) {
    const int q_next = q + 1 < n_chunks ? q + 1 : 0;
    if (i + 1 < n_items) {
      load_tile(tile[(i + 1) & 1], cols_m, k + 1 < n_chunks ? j : j + 1, q_next, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ct = tile[i & 1];
    if (n_chunks > 1) load_row_fragments(a, rows_m, ra, t, d, q * kChunk);
    if (k == 0) zero_scores(s);
    chunk_scores(s, a, ct, g, t);
    q = q_next;
    if (k + 1 < n_chunks) {
      ++k;
      __syncthreads();  // the buffer is refilled next iteration
      continue;
    }

    // A in place of S, then packed to bf16 as the next product's A fragments
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int ns = 0; ns < kNSub; ++ns) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + (e >> 1) * 8;
        const int col = j * kBN + ns * 8 + 2 * t + (e & 1);
        const float pc = __expf(s[ns][e] - __ldg(lse_c + col));
        const float pr = __expf(s[ns][e] - lr[e >> 1]);
        float x = (pr + pc) - (col == row + diag_shift ? diag_coef : 0.f);
        x = x - smooth_term;
        v[e] = inv2b * x;
      }
      // columns ns*8.. are depth 0..7 (ns even) or 8..15 (ns odd) of step ns / 2
      pa[ns >> 1][(ns & 1) * 2 + 0] = pack_bf16x2(v[0], v[1]);
      pa[ns >> 1][(ns & 1) * 2 + 1] = pack_bf16x2(v[2], v[3]);
    }

#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
#pragma unroll
      for (int op = 0; op < kOutSub / 2; ++op) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ct + (kc * 16 + lm_row) * kChunkLd + op * 16 + lm_col);
        mma_bf16_16816(acc[2 * op], pa[kc], b[0], b[1]);
        mma_bf16_16816(acc[2 * op + 1], pa[kc], b[2], b[3]);
      }
    }
    __syncthreads();  // the tile buffer is refilled next iteration
    ++j;
    k = 0;
  }

#pragma unroll
  for (int o = 0; o < kOutSub; ++o) {
    const int col = out_chunk * kChunk + o * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra) * d + col) =
        make_float2(acc[o][0], acc[o][1]);
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(ra + 8) * d + col) =
        make_float2(acc[o][2], acc[o][3]);
  }
}

}  // namespace

extern "C" {

// n [rows, d] bf16 (scaled by 1/tau), c [b, d] bf16, row_lse [rows] f32,
// col_lse [b] f32 -> dn [rows, d] f32, dc [b, d] f32 (dc summed over n's
// rows only). d a multiple of 128, rows and b multiples of 64; pointers
// 16-byte aligned (the wrapper checks). inv2b, diag_coef and smooth_term are the f32 constants
// 0.5 / B, 2 (1 - eps) and 2 eps / B of the TPU kernel.
int fused_ce_bwd(const void* n, const void* c, const void* row_lse, const void* col_lse,
                 void* dn, void* dc, int rows, int b, int d, float inv2b, float diag_coef,
                 float smooth_term, int row_offset, void* stream) {
  if (d <= 0 || d % kChunk || rows % kBM || b % kBM || rows <= 0 || b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* nb = static_cast<const __nv_bfloat16*>(n);
  const auto* cb = static_cast<const __nv_bfloat16*>(c);
  const auto* rl = static_cast<const float*>(row_lse);
  const auto* cl = static_cast<const float*>(col_lse);
  // dn: rows of N against the columns of C; the diagonal at c == r + offset
  const Sweep sweep_dn{nb, cb, rl, cl, static_cast<float*>(dn), b, row_offset};
  // dc: rows of C against the columns of N; the diagonal at n == c - offset
  const Sweep sweep_dc{cb, nb, cl, rl, static_cast<float*>(dc), rows, -row_offset};
  const dim3 grid(rows / kBM + b / kBM, d / kChunk);
  ce_bwd_sweeps<<<grid, kThreads, 0, s>>>(sweep_dn, sweep_dc, rows / kBM, d, inv2b, diag_coef,
                                          smooth_term);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_ce_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
