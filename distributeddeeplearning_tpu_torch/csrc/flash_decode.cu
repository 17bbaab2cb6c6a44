// Attention over a paged KV cache, for Hopper (sm_90a): decode, chunked-
// prefill history, speculative verify; f32, bf16 and int8 pages.
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_decode.py:_kernel (launched by _pallas_attention) in its single-
// card variants, one template instance per (query type, page type,
// overlay, head dim):
//   (a) one query per slot (decode);
//   (b) nq queries per slot (chunked prefill: b = 1, nq = C, posmat =
//       offset + arange(C); speculative verify: nq = K + 1);
//   (c) int8 pages with f32 scales per (position, head), dequantized as
//       k * scale in the Pallas order, optionally with the slot's exact
//       in-flight K/V overlaid at its own position (decode, nq = 1;
//       chunked prefill passes no overlay);
// with queries (and the overlay's own K/V) in f32 or bf16 and pages in
// f32, bf16 or int8 -- every pair an engine makes, bf16 weights over an
// int8 cache included -- and head dim hd in {16, 32, 64}.  Every bf16
// value is widened to f32 in registers (the Pallas kernel's
// k.astype(f32)), so a bf16 pool gives the bits an f32 pool holding the
// same values gives.  For every slot b, query qi and head h it computes
//   out[b, qi, h] = softmax_t( q . k_t / sqrt(hd) ) v_t   over t <= posmat[b, qi]
// with scores DIVIDED by sqrt(hd) in f32, natural exp and an f32 output,
// as the reference does.
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
// (int32, >= 0); the overlay's k_own/v_own are [b, h, hd] in q's type
// (strided); out is [b, nq, h, hd] f32, contiguous.
//
// Design.  One block of 8 warps per (head, slot, query).  The warps walk
// the history visible to the query in tiles of 8 positions each (64 per
// block step): warp w takes the absolute positions w*8 + 64*j + u.  The
// order of every sum therefore depends on the absolute position alone,
// never on the page size or the chunk offset, so a paged read equals a
// dense read of the same contents bitwise, and a prefix hit equals a cold
// run.  Positions past posmat[b, qi] are neither read nor weighted (the
// reference's mask gives them weight exactly 0), which keeps a previous
// occupant's stale or poisoned K/V out.  A warp's lanes split a row's hd
// dims: at hd 64 each of the 32 lanes holds 2 (an f32 row is one coalesced
// 256-byte read, a bf16 row 128 bytes as a bf16x2 a lane, an int8 row 64
// bytes as a char2 a lane, plus one scale); at hd 32 each lane holds 1; at
// hd 16 lanes 0..15 hold 1 and lanes 16..31 hold none and add 0.  The dot
// product reduces across all 32 lanes by shuffle, in an order fixed by the
// lane layout alone.  Each warp keeps its own online-softmax (m, l, acc);
// the block merges the 8 partial states in shared memory at the end.  A NaN scale (the int8 quarantine signal)
// makes that position's dequantized K or V NaN, so the slot's output is
// NaN, as a NaN f32 key does.
//
// Bound on the H100.  Decode attention reads the visible K/V history once
// and does 4 flops per history element: it is bound by bytes (3.35 TB/s),
// 2*hd*4 bytes per visible (position, head) in f32, 2*hd*2 in bf16,
// 2*(hd + 4) in int8.
// Chunked prefill at nq = 64 does the same 4 flops per element for each
// of the 64 queries over a history it shares: there the function is
// bound by operations, and each query's block re-reads the pages (from
// L2 mostly).  This simple design gives one block per (slot, head,
// query), so at batch 8 and 12 heads only 96 of the 132 SMs work at
// decode, each with few loads in flight.  The later perf PR splits each
// history across blocks (flash-decoding) with a merge pass, and folds a
// chunk's queries into one block; the split boundaries must stay on
// absolute positions for the bitwise properties above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int T = 8;         // positions per warp per step

// The kernel's operands; pointers typed by the template, strides in
// elements.
struct Args {
  const void* q;
  long long q_sb, q_sq, q_sh;
  const void* k_pages;
  const void* v_pages;
  long long page_stride, pos_stride, head_stride;
  const float* k_scale;
  const float* v_scale;
  long long s_page_stride, s_pos_stride, s_head_stride;
  const void* k_own;
  const void* v_own;
  long long own_sb, own_sh;
  const int* tables;
  int nb, page_size;
  const int* posmat;
  float* out;
  int NQ, H;
};

// EL consecutive values at p, widened to f32 (int8 as its integer value).
__device__ __forceinline__ void widen(const float* p, float (&x)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void widen(const float* p, float (&x)[1]) {
  x[0] = *p;
}
__device__ __forceinline__ void widen(const bf16* p, float (&x)[2]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void widen(const bf16* p, float (&x)[1]) {
  x[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void widen(const signed char* p, float (&x)[2]) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  x[0] = static_cast<float>(c.x);
  x[1] = static_cast<float>(c.y);
}
__device__ __forceinline__ void widen(const signed char* p, float (&x)[1]) {
  x[0] = static_cast<float>(*p);
}

// QT: query (and overlay) type, float or bf16; PT: page type, float, bf16
// or signed char (int8, with scale pools); HD: head dim.
template <typename QT, typename PT, bool OVERLAY, int HD>
__global__ void __launch_bounds__(WARPS * 32) flash_decode_kernel(Args a) {
  constexpr bool INT8 = sizeof(PT) == 1;
  constexpr int EL = HD >= 64 ? HD / 32 : 1;  // head dims a lane holds
  constexpr int LANES = HD / EL;              // lanes that hold any
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool on = lane < LANES;  // uniform but at hd 16
  const int NQ = a.NQ;
  const int page_size = a.page_size;

  const int last = min(a.posmat[b * NQ + qi], a.nb * page_size - 1);
  // the overlay's own position (nq == 1, so query 0's position)
  const int own_t = OVERLAY ? a.posmat[b * NQ] : -1;
  const int* tab = a.tables + (long long)b * a.nb;
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);
  float qv[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) qv[e] = 0.f;
  if (on) {
    widen(static_cast<const QT*>(a.q) + b * a.q_sb + qi * a.q_sq +
              h * a.q_sh + EL * lane,
          qv);
  }
  const float div = sqrtf(static_cast<float>(HD));

  float m = -INFINITY;
  float l = 0.f;
  float acc[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) acc[e] = 0.f;
  for (int base = warp * T; base <= last; base += WARPS * T) {
    float s[T];
    float vv[T][EL];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = base + u;
      s[u] = 0.f;
#pragma unroll
      for (int e = 0; e < EL; ++e) vv[u][e] = 0.f;
      if (t <= last && on) {  // t <= last is uniform across the warp
        const long long page = tab[t / page_size];
        const long long row = t % page_size;
        float kk[EL];
        if (OVERLAY && t == own_t) {
          const long long o = b * a.own_sb + h * a.own_sh + EL * lane;
          widen(static_cast<const QT*>(a.k_own) + o, kk);
          widen(static_cast<const QT*>(a.v_own) + o, vv[u]);
        } else {
          const long long off = page * a.page_stride + row * a.pos_stride +
                                (long long)h * a.head_stride + EL * lane;
          widen(kp + off, kk);
          widen(vp + off, vv[u]);
          if constexpr (INT8) {
            const long long so = page * a.s_page_stride +
                                 row * a.s_pos_stride +
                                 (long long)h * a.s_head_stride;
            const float ks = a.k_scale[so];
            const float vs = a.v_scale[so];
            // widen, then scale: the Pallas order k.astype(f32) * scale
#pragma unroll
            for (int e = 0; e < EL; ++e) {
              kk[e] = kk[e] * ks;
              vv[u][e] = vv[u][e] * vs;
            }
          }
        }
        if constexpr (EL == 2) {
          s[u] = fmaf(qv[0], kk[0], qv[1] * kk[1]);
        } else {
          s[u] = qv[0] * kk[0];
        }
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
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (base + u <= last) {
        const float p = expf(s[u] - m_new);  // NaN keys stay NaN
        l += p;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (on) {
#pragma unroll
    for (int e = 0; e < EL; ++e) sm_acc[warp][EL * lane + e] = acc[e];
  }
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
    a.out[(((long long)b * NQ + qi) * a.H + h) * HD + d] = o / fmaxf(L, 1e-30f);
  }
}

template <typename QT, typename PT, bool OVERLAY>
int launch(const Args& a, int B, int HD, cudaStream_t stream) {
  const dim3 grid(a.H, B, a.NQ);
  switch (HD) {
    case 16:
      flash_decode_kernel<QT, PT, OVERLAY, 16><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    case 32:
      flash_decode_kernel<QT, PT, OVERLAY, 32><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    case 64:
      flash_decode_kernel<QT, PT, OVERLAY, 64><<<grid, WARPS * 32, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(const Args& a, int page_type, int B, int HD,
                 cudaStream_t stream) {
  switch (page_type) {
    case 0:
      return launch<QT, float, false>(a, B, HD, stream);
    case 1:
      return launch<QT, bf16, false>(a, B, HD, stream);
    case 2:
      return a.k_own != nullptr
                 ? launch<QT, signed char, true>(a, B, HD, stream)
                 : launch<QT, signed char, false>(a, B, HD, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_type: 0 f32, 1 bf16 (the overlay's k_own/v_own share it); page_type:
// 0 f32, 1 bf16, 2 int8 (k_scale/v_scale then give the f32 scale pools;
// k_own == nullptr launches it without the overlay, which the wrapper
// allows at NQ == 1 only); hd: 16, 32 or 64.  Returns a cudaError_t.
extern "C" int flash_decode(
    const void* q, int q_type, long long q_sb, long long q_sq, long long q_sh,
    const void* k_pages, const void* v_pages, int page_type,
    long long page_stride, long long pos_stride, long long head_stride,
    const float* k_scale, const float* v_scale, long long s_page_stride,
    long long s_pos_stride, long long s_head_stride, const void* k_own,
    const void* v_own, long long own_sb, long long own_sh,
    const int* tables, int nb, int page_size, const int* posmat, float* out,
    int B, int NQ, int H, int HD, void* stream) {
  const Args a{q,           q_sb,          q_sq,         q_sh,
               k_pages,     v_pages,       page_stride,  pos_stride,
               head_stride, k_scale,       v_scale,      s_page_stride,
               s_pos_stride, s_head_stride, k_own,       v_own,
               own_sb,      own_sh,        tables,       nb,
               page_size,   posmat,        out,          NQ,
               H};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_type) {
    case 0:
      return launch_pages<float>(a, page_type, B, HD, st);
    case 1:
      return launch_pages<bf16>(a, page_type, B, HD, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
