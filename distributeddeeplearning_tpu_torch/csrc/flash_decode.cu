// Attention over a paged KV cache, for Hopper (sm_90a): decode, chunked-
// prefill history, int8 pages.
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_decode.py:_kernel (launched by _pallas_attention) in three of its
// variants, one template instantiated per variant:
//   (a) float32 pages, one query per slot (decode);
//   (b) float32 pages, nq queries per slot (chunked prefill: b = 1,
//       nq = C, posmat = offset + arange(C));
//   (c) int8 pages with f32 scales per (position, head), dequantized as
//       k * scale in the Pallas order, optionally with the slot's exact
//       in-flight f32 K/V overlaid at its own position (decode, nq = 1;
//       chunked prefill passes no overlay).
// For every slot b, query qi and head h it computes
//   out[b, qi, h] = softmax_t( q . k_t / sqrt(hd) ) v_t   over t <= posmat[b, qi]
// with scores DIVIDED by sqrt(hd) and natural exp, as the reference does.
//
// Contract (the TPU kernel's): q is [b, nq, h, hd] (strided; hd
// contiguous), K/V live in a page pool addressed through block tables
// [b, nb] (int32): logical position t of slot b is row t % page_size of
// page tables[b, t / page_size], at
//   page * page_stride + (t % page_size) * pos_stride + head * head_stride
// (elements), and its int8 scale at the same (page, row, head) through
// the scale pool's own strides.  The strides let a per-layer view of a
// pool [P, L, page_size, h, hd] (page stride L*page_size*h*hd) or of the
// dense cache [slots, L, S, h, hd] (one page of S per slot, identity
// tables) be read in place -- no pool is ever copied.  posmat is [b, nq]
// (int32, >= 0); the overlay's k_own/v_own are [b, h, hd] f32 (strided);
// out is [b, nq, h, hd] contiguous.
//
// Design.  One block of 8 warps per (head, slot, query).  The warps walk
// the history visible to the query in tiles of 8 positions each (64 per
// block step): warp w takes the absolute positions w*8 + 64*j + u.  The
// order of every sum therefore depends on the absolute position alone,
// never on the page size or the chunk offset, so a paged read equals a
// dense read of the same contents bitwise, and a prefix hit equals a cold
// run.  Positions past posmat[b, qi] are neither read nor weighted (the
// reference's mask gives them weight exactly 0), which keeps a previous
// occupant's stale or poisoned K/V out.  A warp's 32 lanes hold 2 of the
// 64 head dims each: an f32 K or V row is one coalesced 256-byte read, an
// int8 row one 64-byte read (a char2 a lane) plus one scale; the dot
// product reduces across lanes by shuffle.  Each warp keeps its own
// online-softmax (m, l, acc); the block merges the 8 partial states in
// shared memory at the end.  A NaN scale (the int8 quarantine signal)
// makes that position's dequantized K or V NaN, so the slot's output is
// NaN, as a NaN f32 key does.
//
// Bound on the H100.  Decode attention reads the visible K/V history once
// and does 4 flops per history element: it is bound by bytes (3.35 TB/s),
// 2*hd*4 bytes per visible (position, head) in f32, 2*(hd + 4) in int8.
// Chunked prefill at nq = 64 does the same 4 flops per element for each
// of the 64 queries over a history it shares: there the function is
// bound by operations, and each query's block re-reads the pages (from
// L2 mostly).  This simple design gives one block per (slot, head,
// query), so at batch 8 and 12 heads only 96 of the 132 SMs work at
// decode, each with few loads in flight.  The later perf PR splits each
// history across blocks (flash-decoding) with a merge pass, and folds a
// chunk's queries into one block; the split boundaries must stay on
// absolute positions for the bitwise properties above.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;       // head dim (the wrapper rejects others)
constexpr int WARPS = 8;
constexpr int T = 8;         // positions per warp per step

template <bool INT8, bool OVERLAY>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const float* __restrict__ q, long long q_sb,
                    long long q_sq, long long q_sh,
                    const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages, long long page_stride,
                    long long pos_stride, long long head_stride,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    long long s_page_stride, long long s_pos_stride,
                    long long s_head_stride,
                    const float* __restrict__ k_own,
                    const float* __restrict__ v_own, long long own_sb,
                    long long own_sh, const int* __restrict__ tables, int nb,
                    int page_size, const int* __restrict__ posmat,
                    float* __restrict__ out, int NQ, int H) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int last = min(posmat[b * NQ + qi], nb * page_size - 1);
  // the overlay's own position (nq == 1, so query 0's position)
  const int own_t = OVERLAY ? posmat[b * NQ] : -1;
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
        const long long page = tab[t / page_size];
        const long long row = t % page_size;
        float2 kk;
        if (OVERLAY && t == own_t) {
          const long long o = b * own_sb + h * own_sh + 2 * lane;
          kk = *reinterpret_cast<const float2*>(k_own + o);
          vv[u] = *reinterpret_cast<const float2*>(v_own + o);
        } else {
          const long long off = page * page_stride + row * pos_stride +
                                (long long)h * head_stride + 2 * lane;
          if constexpr (INT8) {
            const long long so = page * s_page_stride + row * s_pos_stride +
                                 (long long)h * s_head_stride;
            const float ks = k_scale[so];
            const float vs = v_scale[so];
            const char2 kc = *reinterpret_cast<const char2*>(
                static_cast<const signed char*>(k_pages) + off);
            const char2 vc = *reinterpret_cast<const char2*>(
                static_cast<const signed char*>(v_pages) + off);
            // widen, then scale: the Pallas order k.astype(f32) * scale
            kk = make_float2(static_cast<float>(kc.x) * ks,
                             static_cast<float>(kc.y) * ks);
            vv[u] = make_float2(static_cast<float>(vc.x) * vs,
                                static_cast<float>(vc.y) * vs);
          } else {
            kk = *reinterpret_cast<const float2*>(
                static_cast<const float*>(k_pages) + off);
            vv[u] = *reinterpret_cast<const float2*>(
                static_cast<const float*>(v_pages) + off);
          }
        }
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

// Variants (a) and (b): float32 pages.
extern "C" int flash_decode_f32(
    const float* q, long long q_sb, long long q_sq, long long q_sh,
    const float* k_pages, const float* v_pages, long long page_stride,
    long long pos_stride, long long head_stride, const int* tables, int nb,
    int page_size, const int* posmat, float* out, int B, int NQ, int H,
    void* stream) {
  const dim3 grid(H, B, NQ);
  flash_decode_kernel<false, false><<<grid, WARPS * 32, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      q, q_sb, q_sq, q_sh, k_pages, v_pages, page_stride, pos_stride,
      head_stride, nullptr, nullptr, 0, 0, 0, nullptr, nullptr, 0, 0, tables,
      nb, page_size, posmat, out, NQ, H);
  return static_cast<int>(cudaGetLastError());
}

// Variant (c): int8 pages with f32 scale pools; k_own == nullptr launches
// it without the overlay (the wrapper allows the overlay at NQ == 1 only).
extern "C" int flash_decode_int8(
    const float* q, long long q_sb, long long q_sq, long long q_sh,
    const signed char* k_pages, const signed char* v_pages,
    long long page_stride, long long pos_stride, long long head_stride,
    const float* k_scale, const float* v_scale, long long s_page_stride,
    long long s_pos_stride, long long s_head_stride, const float* k_own,
    const float* v_own, long long own_sb, long long own_sh,
    const int* tables, int nb, int page_size, const int* posmat, float* out,
    int B, int NQ, int H, void* stream) {
  const dim3 grid(H, B, NQ);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_own != nullptr) {
    flash_decode_kernel<true, true><<<grid, WARPS * 32, 0, st>>>(
        q, q_sb, q_sq, q_sh, k_pages, v_pages, page_stride, pos_stride,
        head_stride, k_scale, v_scale, s_page_stride, s_pos_stride,
        s_head_stride, k_own, v_own, own_sb, own_sh, tables, nb, page_size,
        posmat, out, NQ, H);
  } else {
    flash_decode_kernel<true, false><<<grid, WARPS * 32, 0, st>>>(
        q, q_sb, q_sq, q_sh, k_pages, v_pages, page_stride, pos_stride,
        head_stride, k_scale, v_scale, s_page_stride, s_pos_stride,
        s_head_stride, nullptr, nullptr, 0, 0, tables, nb, page_size, posmat,
        out, NQ, H);
  }
  return static_cast<int>(cudaGetLastError());
}
