// Building blocks of the port's bf16 tensor-core kernels (flash_attn_fwd_tc.cu,
// flash_attn_dkv_tc.cu, flash_attn_dq_tc.cu): 16-byte cp.async copies into
// XOR-swizzled shared tiles, ldmatrix fragment loads, and the m16n8k16 bf16
// mma.sync with f32 accumulators. Plain inline PTX; the instructions date
// from sm_80 and run on sm_90a.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of 2 bf16: a[0] = (row g, cols 2t..2t+1),
//     a[1] = (row g + 8, cols 2t..), a[2] = (row g, cols 8 + 2t..), a[3] = (row
//     g + 8, cols 8 + 2t..).
//   B (16 x 8, k by n), 2 registers: b[0] = (k rows 2t..2t+1, col g), b[1] =
//     (k rows 8 + 2t.., col g).
//   C (16 x 8, f32), 4 floats: c[0..1] = (row g, cols 2t..2t+1), c[2..3] =
//     (row g + 8, cols 2t..).
// The C layout of two neighbouring n8 tiles is the A layout of one k16 slice,
// so a product's f32 result becomes the next product's A operand in registers
// (acc_to_a).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace ptk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, cached in L2 only
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: (16 x 16 bf16) . (16 x 8 bf16) in f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of one k16 slice from the f32 accumulators of the two n8
// tiles that cover its 16 columns, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// Element offset of (row, col) in a row-major shared tile of D-wide bf16
// rows whose 16-byte chunks are permuted by chunk ^= row % 8. ldmatrix reads
// one 16-byte chunk from each of 8 consecutive rows at the same column; the
// XOR spreads those over the 8 distinct 4-bank groups, so no read conflicts.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// cp.async of rows [0, ROWS) x cols [0, D) of a bf16 matrix with row stride
// `ld` elements into a swizzled tile, 16 bytes per copy, by NT threads.
// `src` and `ld` must keep every row 16-byte aligned (the wrapper checks).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* src,
                                                long long ld) {
  constexpr int ROW_CHUNKS = D / 8;
  constexpr int CHUNKS = ROWS * ROW_CHUNKS;
  static_assert(CHUNKS % NT == 0, "each thread copies whole chunks");
#pragma unroll
  for (int i = 0; i < CHUNKS / NT; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * NT;
    const int row = c / ROW_CHUNKS;
    const int col = (c % ROW_CHUNKS) * 8;
    cp_async_16(tile + swz<D>(row, col), src + row * ld + col);
  }
}

// cp.async of N contiguous floats (a 16-byte-aligned run)
template <int N>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src) {
  static_assert(N % 4 == 0, "whole 16-byte chunks");
  const int i = static_cast<int>(threadIdx.x);
  if (i < N / 4) cp_async_16(dst + 4 * i, src + 4 * i);
}

// A operand: rows [row0, row0 + 16) x cols [16 kc, 16 kc + 16) of a swizzled
// tile (lanes 0-15 address rows 0-15 at col 0, lanes 16-31 at col 8).
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kc, int lane) {
  ldsm_x4(a, tile + swz<D>(row0 + (lane & 15), kc * 16 + (lane >> 4) * 8));
}

// B operands of two n8 tiles from a tile stored n by k (each row one n,
// e.g. K rows for S = Q . K^T): rows [n0, n0 + 16), k cols [16 kc, 16 kc +
// 16). b[0], b[1] serve n0..n0+7 and b[2], b[3] serve n0+8..n0+15.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int kc, int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           kc * 16 + ((lane >> 3) & 1) * 8));
}

// B operands of two n8 tiles from a tile stored k by n (each row one k,
// e.g. V rows for O = P . V), transposed by ldmatrix: k rows [16 kc, 16 kc +
// 16), n cols [n0, n0 + 16). b[0], b[1] serve n0..n0+7 and b[2], b[3] serve
// n0+8..n0+15.
template <int D>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[4], const bf16* tile,
                                             int kc, int n0, int lane) {
  ldsm_x4_trans(b, tile + swz<D>(kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 n0 + (lane >> 4) * 8));
}

}  // namespace ptk
