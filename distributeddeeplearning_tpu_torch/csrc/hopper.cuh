// Hopper building blocks for the port's tensor-core kernels, sm_90a:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and products,
// register rebalancing between warpgroups, and the host-side encoding of
// TMA tensor maps and per-device launch set-up.  The bf16 flash-attention
// forward (flash_attention_fwd.cu) and backward (flash_attention_bwd.cu)
// are built from them.
//
// Shared-memory tiles.  A TMA tile load with a swizzle writes a box of
// rows of ROW bytes (the head dim D in bf16: 32, 64 or 128 bytes) into
// shared memory in the canonical layout wgmma reads with the same
// swizzle: 32-, 64- or 128-byte swizzle for D = 16, 32, 64 (Swizzle<1,4,3>,
// <2,4,3>, <3,4,3> on the byte address), eight rows forming one atom of
// 8 * ROW bytes.  Tiles start on 1024 bytes, so the pattern starts at
// the tile's first row and the descriptors' base offset is 0.
//
// Descriptors (the 64-bit matrix descriptor of wgmma.mma_async).  Bits
// 0-13: start address >> 4; 16-29: leading byte offset >> 4; 32-45:
// stride byte offset >> 4; 62-63: swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
// For a K-major operand (k contiguous: Q and K in S = Q K^T) the stride
// byte offset is the step between 8-row atoms, 8 * ROW bytes, the leading
// one is unused (1), and the k-step of 16 elements (32 bytes) advances the
// start address by 32 bytes within the swizzled row.  For an MN-major
// operand (n contiguous: V in O = P V, read with the transpose bit) the
// step between 8-row groups along k is again 8 * ROW bytes; the N extent
// (D) is one swizzle atom wide, so the other offset is never stepped
// across; both are set to 8 * ROW.  A k-step of 16 rows advances the start
// by 16 * ROW bytes.  One tile of [rows][D] can so feed a K-major product
// (contracting over D) and an MN-major one (contracting over its rows):
// the backward reads K, Q and dO both ways.
//
// Accumulators.  An m64nN f32 accumulator gives each of the warpgroup's
// 128 threads N / 2 floats: warp w holds rows 16w..16w+15 and, with
// g = lane >> 2 and t = lane & 3, d[4j + e] is (row 16w + g + 8 (e >> 1),
// column 8j + 2t + (e & 1)) -- mma.sync's m16n8 C tile j.  The register A
// operand of m64nNk16 has mma.sync's m16k16 A layout per warp, so a score
// accumulator rounded pairwise to bf16 is the A operand of the next
// product: k-step j / 2 takes bf16mma::pack of (d[4j], d[4j+1]) and of
// (d[4j+2], d[4j+3]) into registers 2 (j & 1) and 2 (j & 1) + 1.
//
// Ordering.  wgmma runs asynchronously to the issuing threads: fence()
// before a product whose accumulator or A registers were written by
// ordinary instructions, commit() and wait<0>() before reading its
// result, and fence_operand() on every register it reads or writes right
// after the wait, so the compiler neither reads an accumulator early nor
// reuses an A register while the product may still read it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p in shared memory (swizzled
// tiles start on one; dynamic shared memory is allocated 1024 bytes over)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// spins ~2^26 times (seconds) traps: a fault in the pipeline's phase
// bookkeeping then ends the launch with an error instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// ---- TMA ----------------------------------------------------------------------

// A box of the 4-D tensor map `map` at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; completion is counted on `bar` in bytes.
// Elements outside the tensor's extents are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma ----------------------------------------------------------------------

// swizzle code of a descriptor for rows of `row_bytes` (32, 64 or 128)
__host__ __device__ constexpr uint64_t swizzle_code(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// descriptor of a tile at `smem_addr` (a shared-memory address) whose rows
// are ROW bytes, swizzled to ROW bytes
template <int ROW>
__device__ __forceinline__ uint64_t desc(uint32_t smem_addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (swizzle_code(ROW) << 62);
}

// K-major operand (Q or K of S = Q K^T), k-step at byte offset 32 * kk
template <int ROW>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t smem_addr) {
  return desc<ROW>(smem_addr, 16, 8 * ROW);
}

// MN-major operand (V of O = P V, transposed), k-step at 16 * ROW * kk
template <int ROW>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t smem_addr) {
  return desc<ROW>(smem_addr, 8 * ROW, 8 * ROW);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A B for m64nNk16, A and B from shared memory (descriptors), both
// K-major; scale_d = 0 overwrites d
template <int N>
struct WgmmaSS;
// d += A B for m64nNk16, A from registers, B from shared memory MN-major
// (the transpose bit set); scale_d = 0 overwrites d
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};


// d = A B^T for a 64-row A tile and an N-row B tile, both K-major [rows][D]
// tiles of ROW-byte rows at shared addresses a and b: D / 16 k-steps,
// issued, not committed (the first overwrites d)
template <int ROW, int N>
__device__ __forceinline__ void ss_k_major(float (&d)[N / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < ROW / 32; ++kk) {
    WgmmaSS<N>::run(d, desc_k_major<ROW>(a + 32 * kk),
                    desc_k_major<ROW>(b + 32 * kk), kk);
  }
}

// d += A B for A in registers (K / 16 k-steps of m64k16) and B a [K][D]
// tile of ROW-byte rows at shared address b, read MN-major: issued, not
// committed
template <int ROW, int K>
__device__ __forceinline__ void rs_mn_major(float (&d)[ROW / 4],
                                            const uint32_t (&a)[K / 16][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    WgmmaRS<ROW / 2>::run(d, a[kk], desc_mn_major<ROW>(b + kk * 16 * ROW), 1);
  }
}

// The four values x of n-tile j of an m64 f32 accumulator (d[4j..4j+3]),
// rounded pairwise to bf16 into the register A operand of k-step j / 2
// (the layout in the note at the top)
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], int j,
                                       const float (&x)[4]) {
  a[j >> 1][(j & 1) * 2] = bf16mma::pack(x[0], x[1]);
  a[j >> 1][(j & 1) * 2 + 1] = bf16mma::pack(x[2], x[3]);
}

// 2^x on the SFU; subnormal results flush to 0 (they are below any bf16
// operand or f32 sum that matters: < 2^-126 of the row's largest term)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// ---- register rebalancing between warpgroups ---------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: TMA tensor maps ------------------------------------------------------

// The driver's cuTensorMapEncodeTiled, reached through the runtime's
// driver entry point, so the libraries need no -lcuda at link time.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled tensor map of `rank` dims (innermost first) over `base`;
// `strides` holds the rank - 1 outer strides in bytes.  Boxes load with
// zero fill outside the extents.  Returns false if the driver refuses.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                         const void* base, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA swizzle for rows of `row_bytes` (32, 64 or 128)
inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A TMA map over a strided [B, S, H, D] bf16 view (strides in elements):
// dims (D, H, S, B), boxes of `rows` rows of one head, swizzled to the row
template <int D>
inline bool encode_rows(CUtensorMap* map, const void* base, long long sb,
                        long long ss, long long sh, int B, int H, int S,
                        int rows) {
  const cuuint64_t dims[4] = {D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {D, 1, (cuuint32_t)rows, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box, swizzle_for(D * 2));
}

// A TMA map over `n` contiguous f32 values as one run, boxes of `box`
// values (a window: a box must start on 16 bytes, so a kernel loads the
// box from `x & ~3` for a run starting at x, and reads from (x & 3) on;
// values past n read as 0)
inline bool encode_window(CUtensorMap* map, const float* base, long long n,
                          int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims,
                      strides, boxes, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Once per device (a bit of `configured` each): raise `kernel`'s dynamic
// shared-memory limit to `smem` bytes and check that its launch register
// count, over `threads` threads, covers the `pool` registers its
// setmaxnreg counts add up to -- else cudaErrorInvalidConfiguration, as
// setmaxnreg.inc would wait forever on a short pool.
template <typename Kernel>
inline cudaError_t configure_once(Kernel kernel, int smem, int threads,
                                  int pool, unsigned long long& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || ((configured >> dev) & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * threads < pool) return cudaErrorInvalidConfiguration;
  configured |= 1ull << dev;
  return cudaSuccess;
}

// Rows a block of the warp-specialised attention kernels owns (64 a
// consumer warpgroup) over B * H heads of S rows: 192 when that grid
// gives every SM four blocks (and max_rows allows), 128 when it gives
// every SM one, else 64 -- more rows share each streamed tile among more
// warpgroups, fewer spread short sequences over more SMs; 64 if the SM
// count cannot be read.
inline int block_rows(int B, int H, int S, int max_rows) {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 64;
  }
  const long long heads = (long long)B * H;
  if (max_rows >= 192 && heads * ((S + 191) / 192) >= 4LL * sms) return 192;
  return heads * ((S + 127) / 128) >= sms ? 128 : 64;
}

}  // namespace hopper
