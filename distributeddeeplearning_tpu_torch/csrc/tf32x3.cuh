// Split-TF32 ("3xTF32") building blocks of the port's f32 flash-attention
// kernels on Hopper's tensor cores (sm_90a, mma.sync m16n8k8): the
// forward (flash_attention_fwd.cu, flash_fwd_f32_kernel) and the
// backward's two passes (flash_attention_bwd.cu, flash_bwd_dq_f32_kernel
// and flash_bwd_dkv_f32_kernel) are built from them.
//
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (tf32(): keep 10 explicit mantissa bits, round the 13 dropped ones to
// nearest, ties away from zero), and a b is summed as a_lo b_hi +
// a_hi b_lo + a_hi b_hi in f32 (the dropped a_lo b_lo is ~2^-22 of the
// product): f32 accuracy at a third of the TF32 rate.
//
// Tiles in shared memory keep rows of D + 4 floats: 16 bytes a row stay
// aligned for cp.async and ldmatrix, and both fragment layouts below read
// them without bank conflicts.  A streamed tile goes through a two-stage
// cp.async ring (F32_STAGES) and is split once a block into a hi and a lo
// tile (split_tile; the forward splits in place, its hi tile the raw one),
// which every warp then reads, A and B fragments through ldmatrix at
// a_frag_offset and b_frag_offset.  A warp owns 16 rows; its accumulators
// are m16n8k8 C fragments: with g = lane >> 2 and
// t = lane & 3, element e of C tile j is (row g + 8 (e >> 1), column
// 8j + 2t + (e & 1)).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace tf32x3 {

constexpr int F32_STAGES = 2;  // depth of the streamed ring

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the 13 low mantissa bits
// dropped, to nearest, ties away from zero (adding half their range to the
// sign-magnitude pattern carries into bit 13 exactly when they are >= half)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // exact difference, then rounded
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&raw)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(raw[i]), hi[i], lo[i]);
}

// c (m16n8, f32) += a (m16k8) b (k8n8), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to f32 accuracy from split operands: the two small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Four 8 x 4 f32 blocks (as 8 x 8 b16 matrices), lane l giving the row
// address of block l / 8, row l % 8: lane (g, t) receives element [g][t]
// of each block, the tf32 fragment layout.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// 4-byte async copy global -> shared; when !valid nothing is read and the
// word is zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Where lane starts its ldsm4 in a tile of rows of D + 4 floats, relative to
// the fragment's first row and k: for an A operand (16 rows x k 8) blocks
// (rows 0-7 | 8-15) x (k 0-3 | 4-7) -> a0, a1, a2, a3; for the B operands
// of two C tiles (16 rows, each an n of 8, x k 8) blocks (k 0-3 | 4-7) x
// (rows 0-7 | 8-15) -> b0, b1 of the first tile, b0, b1 of the second.
template <int D>
__device__ __forceinline__ int a_frag_offset(int lane) {
  const int mi = lane >> 3;  // the ldmatrix block this lane addresses
  const int ri = lane & 7;   // and its row there
  return (ri + 8 * (mi & 1)) * (D + 4) + 4 * (mi >> 1);
}

template <int D>
__device__ __forceinline__ int b_frag_offset(int lane) {
  const int mi = lane >> 3;
  const int ri = lane & 7;
  return (ri + 8 * (mi >> 1)) * (D + 4) + 4 * (mi & 1);
}

// rows [r0, r0 + ROWS) of a strided [S, D] head slice into rows of D + 4
// floats, 16 bytes a cp.async; rows past S are zero-filled, never read
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int r0, int S,
                                          int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int f = tid; f < ROWS * CH; f += THREADS) {
    const int r = f / CH;
    const int c = (f % CH) * 4;
    const bool ok = r0 + r < S;
    bf16mma::cp_async16(dst + r * (D + 4) + c,
                        src + (ok ? (long long)(r0 + r) * stride + c : 0), ok);
  }
}

// values [x0, x0 + N) of a run of S floats (past S: zero)
template <int N, int THREADS>
__device__ __forceinline__ void copy_window(float* dst, const float* src,
                                            int x0, int S, int tid) {
  for (int i = tid; i < N; i += THREADS) {
    const bool ok = x0 + i < S;
    cp_async4(dst + i, src + (ok ? x0 + i : 0), ok);
  }
}

// A streamed tile's BN rows of f32 values split into TF32 parts, hi and lo
// in tiles of the same layout, 16 bytes a thread at a time; the block's
// warps then load the parts instead of each splitting every value it uses.
// hi may be raw itself: each thread reads its 16 bytes before it writes
// them.
template <int D, int BN, int THREADS>
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo,
                                           const float* raw, int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int f = tid; f < BN * CH; f += THREADS) {
    const int at = (f / CH) * (D + 4) + (f % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// acc (16 rows x D) += X T for X = the 16 x BN C fragments x (the warp's
// rows against the streamed rows) and T the streamed tile (BN x D, its TF32
// parts Th, Tl): x's C tile j is the A operand of k-step j, its columns 2t,
// 2t + 1 standing for k = t, t + 4, and the B operand takes T's rows
// 8j + 2t, 8j + 2t + 1.
// The tile's products are summed in a fresh accumulator and added to acc
// once: the tensor cores' f32 accumulation rounds its sums toward zero, a
// bias that would grow with the number of streamed tiles in one chain of
// products, while an f32 addition a tile rounds to nearest.
template <int D, int BN>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[BN / 8][4],
                                           const uint32_t* Th,
                                           const uint32_t* Tl, int g, int t) {
  constexpr int LD = D + 4;
  float part[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
  }
  const int col = 2 * t * LD + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(x[j][0], ah[0], al[0]);  // row g,     k = t     (col 2t)
    split_tf32(x[j][2], ah[1], al[1]);  // row g + 8, k = t
    split_tf32(x[j][1], ah[2], al[2]);  // row g,     k = t + 4 (col 2t + 1)
    split_tf32(x[j][3], ah[3], al[3]);  // row g + 8, k = t + 4
    const int row = col + 8 * j * LD;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      mma3(part[n], ah, al, Th[row + 8 * n], Th[row + LD + 8 * n],
           Tl[row + 8 * n], Tl[row + LD + 8 * n]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// this thread's two rows (row, row + 8) of a [B, S, H, D] f32 output
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[D / 8][4],
                                               int b, int h, int H, int S,
                                               int row, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    float* orow = out + (((long long)b * S + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

}  // namespace tf32x3
