// Small helpers shared by the port's kernels, sm_90a: the rounding of two
// f32 values into one register of a bf16 tensor-core operand, the
// constants of the base-2 softmax, and 16-byte cp.async copies.  The bf16
// flash-attention forward and backward (flash_attention_fwd.cu,
// flash_attention_bwd.cu) run wgmma from hopper.cuh and take pack() and the
// constants; the f32 kernels take LN2 for the key-padding bias in nats; the
// decode kernel (flash_decode.cu) stages its tiles with cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Two floats rounded to bf16 (nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

}  // namespace bf16mma
