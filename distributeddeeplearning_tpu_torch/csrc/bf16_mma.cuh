// Warp-level bf16 tensor-core helpers of the bf16 flash-attention backward
// (flash_attention_bwd.cu), sm_90a; the forward (flash_attention_fwd.cu,
// built on wgmma from hopper.cuh) takes pack() and the constants.
//
// Products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: a
// 16 x 16 bf16 A tile times a 16 x 8 bf16 B tile into a 16 x 8 f32
// accumulator.  With g = lane >> 2 and t = lane & 3, a thread holds
//   A: a0 = (row g,   cols 2t, 2t+1)   a1 = (row g+8, cols 2t, 2t+1)
//      a2 = (row g,   cols 2t+8, +9)   a3 = (row g+8, cols 2t+8, +9)
//   B: b0 = (k rows 2t, 2t+1, col g)   b1 = (k rows 2t+8, 2t+9, col g)
//   C: c0, c1 = (row g, cols 2t, 2t+1) c2, c3 = (row g+8, cols 2t, 2t+1)
// (the lower k or column index in the lower 16 bits of a register).  So a
// row's values sit in the four lanes of one quad, and a C tile rounded to
// bf16 is, pair for pair, the A operand of the next product.
//
// Tiles are staged in shared memory as rows of D bf16 (the head dim: 16,
// 32 or 64, a multiple of the 16-deep k-step) padded to LDS = D + 8
// elements (48, 80 or 144 bytes): the eight 16-byte rows one ldmatrix
// phase reads then fall on eight different groups of four banks (row r
// starts at bank 4 * (r * (D / 8 + 1) mod 8), and D / 8 + 1 is odd), and
// every row start stays 16-byte aligned for cp.async and ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

// the padded shared-memory row of a head-dim-D tile, in elements
template <int D>
struct Tile {
  static constexpr int LDS = D + 8;
};
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; when !valid nothing is read and
// the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a strided [S, D] head slice into a
// [ROWS][Tile<D>::LDS] tile, 16 bytes a copy; rows past S are zero.  Needs a
// 16-byte aligned base and a row stride that is a multiple of 8 elements
// (the wrapper checks both).
template <int ROWS, int THREADS, int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long stride, int r0,
                                                int S, int tid) {
#pragma unroll
  for (int f = tid; f < ROWS * (D / 8); f += THREADS) {
    const int r = f / (D / 8);
    const int c = (f % (D / 8)) * 8;
    const bool ok = r0 + r < S;
    const bf16* g = ok ? src + (long long)(r0 + r) * stride + c : src;
    cp_async16(dst + r * Tile<D>::LDS + c, g, ok);
  }
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i returns matrix i's fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way: lane (g, t) receives
// elements (2t, g) and (2t+1, g) of the stored matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b over one m16n8k16 step.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk from C tiles 2kk and 2kk+1 of a 16-row
// accumulator (a score or gradient tile), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Address of this lane's row for an A-operand ldmatrix.x4 (16 rows from
// row0, 16 columns from col0) of a [*][LDS] tile: matrices (rows 0-7,
// cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) = a0..a3.
template <int LDS>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int row0,
                                              int col0, int lane) {
  return tile + (row0 + (lane & 15)) * LDS + col0 + (lane >> 4) * 8;
}

// Address for a B-operand ldmatrix.x4 when the tile stores B^T row-major
// ([n][k], e.g. K for S = Q K^T): two n-tiles (n0, n0+8) of one k-step
// (16 columns from k0); returns b0, b1 of n-tile n0 then of n0+8.
template <int LDS>
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int n0,
                                               int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDS + k0 +
         ((lane >> 3) & 1) * 8;
}

// Address for a B-operand ldmatrix.x4.trans when the tile stores B
// row-major ([k][n], e.g. V for O = P V): k-step rows k0..k0+15, two
// n-tiles (n0, n0+8); returns b0, b1 of n-tile n0 then of n0+8.
template <int LDS>
__device__ __forceinline__ const bf16* b_addr_t(const bf16* tile, int k0,
                                                int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + n0 +
         (lane >> 4) * 8;
}

}  // namespace bf16mma
