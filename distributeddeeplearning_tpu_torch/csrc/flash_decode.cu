// Decode attention over a paged KV cache, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_decode.py:_kernel (launched by _pallas_attention), variant (a):
// float32 pages, no int8 dequant, no own-token overlay.  For every slot b,
// query qi and head h it computes
//   out[b, qi, h] = softmax_t( q . k_t / sqrt(hd) ) v_t   over t <= posmat[b, qi]
// with scores DIVIDED by sqrt(hd) and natural exp, as the reference does.
//
// Contract (kept from the TPU kernel so later slices extend it): q is
// [b, nq, h, hd] (strided; hd contiguous), K/V live in a page pool
// addressed through block tables [b, nb] (int32): logical position t of
// slot b is row t % page_size of page tables[b, t / page_size], at
//   page * page_stride + (t % page_size) * pos_stride + head * head_stride.
// The strides let the dense cache's per-layer view [slots, S, h, hd]
// (slot stride L*S*h*hd, not contiguous) be read in place as one page of
// page_size = S per slot with identity tables -- the cache is never copied.
// posmat is [b, nq] (int32, >= 0); out is [b, nq, h, hd] contiguous.
//
// Design.  One block of 8 warps per (head, slot, query).  The warps walk
// the slot's visible history in tiles of 8 positions each (64 per block
// step); positions past posmat[b, qi] are neither read nor weighted, which
// is the reference's mask (their weight is exactly 0 there) and keeps a
// previous occupant's stale or poisoned K/V out.  A warp's 32 lanes hold 2
// of the 64 head dims each, so each position's K and V rows are one
// coalesced 256-byte read; the dot product reduces across lanes by
// shuffle.  Each warp keeps its own online-softmax (m, l, acc); the block
// merges the 8 partial states in shared memory at the end.
//
// Bound on the H100.  Decode attention reads the visible K/V history once
// and does 4 flops per history element: it is bound by bytes (3.35 TB/s).
// This simple design gives one block per (slot, head), so at batch 8 and
// 12 heads only 96 of the 132 SMs work, each with few loads in flight.
// The later perf PR splits each history across blocks (flash-decoding)
// with a merge pass; its split boundaries must fall on page indices, so
// that a prefix hit computes bit-identically to a cold run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;       // head dim (the wrapper rejects others)
constexpr int WARPS = 8;
constexpr int T = 8;         // positions per warp per step

__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const float* __restrict__ q, long long q_sb,
                    long long q_sq, long long q_sh,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages, long long page_stride,
                    long long pos_stride, long long head_stride,
                    const int* __restrict__ tables, int nb, int page_size,
                    const int* __restrict__ posmat, float* __restrict__ out,
                    int NQ, int H) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int last = min(posmat[b * NQ + qi], nb * page_size - 1);
  const int* tab = tables + (long long)b * nb;
  const float2 qv = *reinterpret_cast<const float2*>(
      q + b * q_sb + qi * q_sq + h * q_sh + 2 * lane);
  const float div = sqrtf(static_cast<float>(HD));

  float m = -INFINITY;
  float l = 0.f;
  float2 acc = make_float2(0.f, 0.f);
  for (int base = warp * T; base <= last; base += WARPS * T) {
    float s[T];
    float2 vv[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = base + u;
      s[u] = 0.f;
      vv[u] = make_float2(0.f, 0.f);
      if (t <= last) {  // uniform across the warp
        const long long off = (long long)tab[t / page_size] * page_stride +
                              (long long)(t % page_size) * pos_stride +
                              (long long)h * head_stride + 2 * lane;
        const float2 kk = *reinterpret_cast<const float2*>(k_pages + off);
        vv[u] = *reinterpret_cast<const float2*>(v_pages + off);
        s[u] = fmaf(qv.x, kk.x, qv.y * kk.y);
      }
    }
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (base + u <= last) {
        s[u] = s[u] / div;
        mx = fmaxf(mx, s[u]);
      }
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);  // 0 on the warp's first step
    l *= corr;
    acc.x *= corr;
    acc.y *= corr;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (base + u <= last) {
        const float p = expf(s[u] - m_new);  // NaN keys stay NaN
        l += p;
        acc.x = fmaf(p, vv[u].x, acc.x);
        acc.y = fmaf(p, vv[u].y, acc.y);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_acc[warp][2 * lane] = acc.x;
  sm_acc[warp][2 * lane + 1] = acc.y;
  __syncthreads();
  if (threadIdx.x < HD) {
    const int d = threadIdx.x;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp that saw no position holds (-inf, 0, 0) and weighs 0
      const float e = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - M);
      L = fmaf(sm_l[w], e, L);
      o = fmaf(sm_acc[w][d], e, o);
    }
    out[(((long long)b * NQ + qi) * H + h) * HD + d] = o / fmaxf(L, 1e-30f);
  }
}

}  // namespace

extern "C" int flash_decode_f32(
    const float* q, long long q_sb, long long q_sq, long long q_sh,
    const float* k_pages, const float* v_pages, long long page_stride,
    long long pos_stride, long long head_stride, const int* tables, int nb,
    int page_size, const int* posmat, float* out, int B, int NQ, int H,
    void* stream) {
  const dim3 grid(H, B, NQ);
  flash_decode_kernel<<<grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, q_sb, q_sq, q_sh, k_pages, v_pages, page_stride, pos_stride,
      head_stride, tables, nb, page_size, posmat, out, NQ, H);
  return static_cast<int>(cudaGetLastError());
}
