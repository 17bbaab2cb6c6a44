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
// int8 cache included -- and head dim hd in {16, 32, 64}.  Every value is
// widened to f32 before any product (the Pallas kernel's k.astype(f32)),
// so a bf16 pool gives the bits an f32 pool holding the same values
// gives.  For every slot b, query qi and head h it computes
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
// tables) be read in place -- no pool is ever copied.  Page rows must
// start on 16 bytes (the wrapper checks it).  posmat is [b, nq] (int32,
// >= 0); the overlay's k_own/v_own are [b, h, hd] in q's type (strided);
// part is the f32 scratch [b, nq, h, nsplit, hd + 2]; out is [b, nq, h,
// hd] f32, contiguous.
//
// Design: split, stage, fold, merge.
//   Split.  Each slot's history is cut at absolute positions into spans of
// SPAN = 64 positions (a compile-time constant, never a function of page
// size, nb, nq, batch or history; of 32, 64 and 128, swept on an H100
// with experimental builds, 64 was the fastest at 12 of the 16 rows and
// within 10% of the fastest at the others).  Pass 1
// (flash_decode_split_kernel) runs one block per (span, head, slot): at
// the decode shape (b 8, h 12, S 576) 864 blocks instead of 96.  A block
// whose span starts past every query's last visible position exits at
// once.  A query with last position L uses spans 0 .. L / SPAN.
//   Stage.  Three reads go out together first: the queries' positions, the
// page and row of each position of the span (one division per position
// per block, not per lane per step) and each warp's first query.  Then the
// K and V rows of the span, up to the block's largest visible position and
// no further, go to shared memory 16 bytes a thread, every row in flight
// at once: f32 rows by cp.async straight into the f32 tile; bf16 and int8
// rows by 16-byte loads into registers, all issued before any is used,
// then widened (int8: times the row's scale, one rounding, the Pallas
// order) into the f32 tile, the overlay's own K/V replacing the row at its
// position.  The tile's rows are padded to hd + 4 floats so that lanes
// reading eight consecutive rows 16 bytes at a time hit eight groups of
// banks.
//   Fold.  Every query of the slot is served from the one staged tile, a
// warp per query (a block has min(max(nq, 4), 16) warps; warp w takes
// queries w, w + warps, ...): the tile is read from device memory once for
// a chunk's 64 queries or a verify pass's K+1.  Lane j scores positions j,
// j + 32, ... of the span (q . k in f32 with four partial sums over d mod
// 4, added as (a0 + a1) + (a2 + a3), then divided by sqrt(hd)); the span's
// max by shuffle; p = exp(s - max) for visible positions, 0 past the
// query's last; l the sum of p by a shuffle tree; acc[d] = sum_t p_t v_t[d]
// with each lane owning hd / 32 dims, in two chains over even and odd
// positions, each ascending, added at the end.  Positions past the query's
// last are neither read nor weighted, so a previous occupant's stale or
// poisoned K/V stays out.  The block writes each query's (m, l, acc) to the
// scratch.
//   Merge.  Pass 2 (flash_decode_merge_kernel), a thread per (slot, query,
// head, dim), combines spans 0 .. L / SPAN in ascending order, reading 8
// spans' states at once: M = max m, e = exp(m - M) (0 for a span that saw
// no position, m = -inf; a NaN l still poisons through the fma), L = sum
// l e, o = sum acc e, out = o / max(L, 1e-30).  Both passes launch from the
// one C entry point, each launch's cudaGetLastError() checked.  The single
// launch in which the last block of a (slot, head), found through an
// atomic ticket, merges was measured on an H100 as no faster at decode
// (0.0110 against 0.0111 ms) and 1.5x slower for a 64-query chunk (0.0353
// against 0.0232 ms: one block merges all 64 queries in series); two
// launches also keep the kernel free of state between calls.
//
// Every sum runs in an order fixed by the absolute position and hd alone,
// and a query's partials come from the same code whatever the other
// queries of the launch are, so: a paged read equals a dense read of the
// same contents bitwise, a prefix hit equals a cold run, a verify column
// equals an nq = 1 launch at its position and a chunk's query a decode at
// its position, and bf16 pages equal an f32 launch on widened copies.  A
// NaN scale (the int8 quarantine signal) or a NaN key at a visible
// position makes that slot's output NaN, and no other slot's.
//
// Bound on the H100.  Decode attention reads the visible K/V history once
// and does 4 flops per history element: at nq <= 5 it is bound by bytes
// (3.35 TB/s), 2*hd*4 bytes per visible (position, head) in f32, 2*hd*2 in
// bf16, 2*(hd + 4) in int8.  A chunk at nq = 64 does the same 4 flops per
// element for each query over a history it shares: its bound is the f32
// operations on CUDA cores (67 TFLOP/s).  Tensor cores are not used: the
// f32 path must stay f32 (TF32 would break the 1e-4 parity), and the bf16
// path must equal the f32 one bitwise.  What holds the kernel above its
// bound is latency, not bytes: the three page types take the same time.
// At decode one warp of a block computes while the others only load, and
// the merge pass costs about 3 us.  At nq = 64 each warp serves four
// queries in series, each reading the whole tile from shared memory:
// serving two queries a warp from one read of a row took the chunk from
// 0.023 to 0.019 ms on an H100 but decode from 0.011 to 0.012 ms, and
// decode launches far more often, so it is not done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16mma::cp_async16;
using bf16mma::cp_async_commit;
using bf16mma::cp_async_wait;

constexpr int SPAN = 64;       // positions a split block stages
constexpr int MIN_WARPS = 4;   // a block's warps: min(max(nq, 4), 16)
constexpr int MAX_WARPS = 16;
constexpr int MERGE_THREADS = 128;
constexpr int MAX_DEVICES = 64;

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
  float* part;
  int nsplit;
  float* out;
  int NQ, H;
};

__device__ __forceinline__ float widen1(const float* p) { return *p; }
__device__ __forceinline__ float widen1(const bf16* p) {
  return __bfloat162float(*p);
}

// The shared-memory layout of a split block, in bytes: the element offset
// of each position's K/V row and of its int8 scales, the f32 K/V tile, and
// per warp its query and its span's probabilities.
template <typename PT, int HD>
struct Smem {
  static constexpr bool NARROW = sizeof(PT) < 4;
  static constexpr int LD = HD + 4;  // floats a padded tile row
  static constexpr size_t ROWS = 0;                        // long long[SPAN]
  static constexpr size_t SROWS = ROWS + 8 * SPAN;         // long long[SPAN]
  static constexpr size_t TILE = SROWS + 8 * SPAN;         // float[2][SPAN][LD]
  static constexpr size_t WARP = TILE + 2 * SPAN * LD * 4;  // float[w][HD + SPAN]
  static constexpr size_t bytes(int warps) {
    return WARP + static_cast<size_t>(warps) * (HD + SPAN) * 4;
  }
};

// 16 bytes of a bf16 or int8 row, widened to f32 (int8 times its scale)
// into dst.
__device__ __forceinline__ void widen16(const uint4& w, float* dst, float,
                                        const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 lo = __bfloat1622float2(h[2 * i]);
    const float2 hi = __bfloat1622float2(h[2 * i + 1]);
    d[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}
__device__ __forceinline__ void widen16(const uint4& w, float* dst,
                                        float scale, const signed char*) {
  const signed char* c = reinterpret_cast<const signed char*>(&w);
  float4* d = reinterpret_cast<float4*>(dst);
  // widen, then scale: the Pallas order k.astype(f32) * scale
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(__fmul_rn(static_cast<float>(c[4 * i]), scale),
                       __fmul_rn(static_cast<float>(c[4 * i + 1]), scale),
                       __fmul_rn(static_cast<float>(c[4 * i + 2]), scale),
                       __fmul_rn(static_cast<float>(c[4 * i + 3]), scale));
}

// A lane's EL consecutive dims of a tile row (8-byte aligned at EL 2).
__device__ __forceinline__ void load_dims(const float* p, float (&x)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void load_dims(const float* p, float (&x)[1]) {
  x[0] = *p;
}

// Query qi of slot b, head h, widened to f32 into the warp's qs.
template <typename QT, int HD>
__device__ __forceinline__ void load_query(const Args& a, int b, int qi, int h,
                                           float* qs, int lane) {
  const QT* qp = static_cast<const QT*>(a.q) + b * a.q_sb + qi * a.q_sq +
                 h * a.q_sh;
  for (int d = lane; d < HD; d += 32) qs[d] = widen1(qp + d);
}

// QT: query (and overlay) type, float or bf16; PT: page type, float, bf16
// or signed char (int8, with scale pools); HD: head dim.
template <typename QT, typename PT, bool OVERLAY, int HD>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    flash_decode_split_kernel(Args a) {
  using L = Smem<PT, HD>;
  constexpr bool INT8 = sizeof(PT) == 1;
  constexpr int LD = L::LD;
  constexpr int EPC = 16 / sizeof(PT);  // elements a 16-byte chunk
  constexpr int CH = HD / EPC;          // chunks a row
  constexpr int PER = SPAN / 32;        // positions a lane scores
  constexpr int EL = HD >= 32 ? HD / 32 : 1;  // dims a lane accumulates
  constexpr int LANES = HD / EL;              // lanes that hold any
  extern __shared__ __align__(16) unsigned char smem[];
  long long* rows = reinterpret_cast<long long*>(smem + L::ROWS);
  long long* srows = reinterpret_cast<long long*>(smem + L::SROWS);
  float* tile = reinterpret_cast<float*>(smem + L::TILE);
  __shared__ int wtop[MAX_WARPS];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int NQ = a.NQ;
  const int ps = a.page_size;
  const int cap = a.nb * ps - 1;
  const int s0 = split * SPAN;
  const int* pm = a.posmat + (long long)b * NQ;
  const int* tab = a.tables + (long long)b * a.nb;
  float* qs = reinterpret_cast<float*>(smem + L::WARP) + warp * (HD + SPAN);
  float* pv = qs + HD;

  // Three independent reads in flight together: the queries' last visible
  // positions, the page and row of each position of the span the table
  // covers (one division a position a block), and each warp's first query.
  int mine = -1;
  for (int qi = tid; qi < NQ; qi += nthreads) mine = max(mine, min(pm[qi], cap));
  for (int r = tid; r < SPAN && s0 + r <= cap; r += nthreads) {
    const int t = s0 + r;
    const int j = t / ps;
    const long long page = tab[j];
    const long long row = t - j * ps;
    rows[r] = page * a.page_stride + row * a.pos_stride +
              (long long)h * a.head_stride;
    if constexpr (INT8)
      srows[r] = page * a.s_page_stride + row * a.s_pos_stride +
                 (long long)h * a.s_head_stride;
  }
  if (warp < NQ) load_query<QT, HD>(a, b, warp, h, qs, lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, off));
  if (lane == 0) wtop[warp] = mine;
  __syncthreads();
  int top = -1;  // the block's largest visible position
  for (int w = 0; w < warps; ++w) top = max(top, wtop[w]);
  if (top < s0) return;  // uniform: no query of the slot sees this span
  const int nrows = min(SPAN, top - s0 + 1);  // rows past top are not read

  // every row of the span in flight at once, 16 bytes a thread
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);
  if constexpr (!L::NARROW) {
    for (int i = tid; i < nrows * CH; i += nthreads) {
      const int r = i / CH;
      const int c = (i % CH) * EPC;
      cp_async16(tile + r * LD + c, kp + rows[r] + c, true);
      cp_async16(tile + (SPAN + r) * LD + c, vp + rows[r] + c, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    // bf16 and int8 rows through registers: every load issued, then each
    // widened into the f32 tile; the overlay replaces its own row here
    constexpr int PERT = (SPAN * CH + MIN_WARPS * 32 - 1) / (MIN_WARPS * 32);
    uint4 kw[PERT], vw[PERT];
    float ks[PERT], vs[PERT];
#pragma unroll
    for (int u = 0; u < PERT; ++u) {
      const int i = tid + u * nthreads;
      ks[u] = vs[u] = 1.f;
      if (i < nrows * CH) {
        const int r = i / CH;
        const int c = (i % CH) * EPC;
        kw[u] = *reinterpret_cast<const uint4*>(kp + rows[r] + c);
        vw[u] = *reinterpret_cast<const uint4*>(vp + rows[r] + c);
        if constexpr (INT8) {
          ks[u] = a.k_scale[srows[r]];
          vs[u] = a.v_scale[srows[r]];
        }
      }
    }
    const int own_r = OVERLAY ? pm[0] - s0 : -1;  // nq == 1: query 0's position
#pragma unroll
    for (int u = 0; u < PERT; ++u) {
      const int i = tid + u * nthreads;
      if (i < nrows * CH) {
        const int r = i / CH;
        const int c = (i % CH) * EPC;
        float* kd = tile + r * LD + c;
        float* vd = tile + (SPAN + r) * LD + c;
        if (OVERLAY && r == own_r) {
          const long long o = b * a.own_sb + h * a.own_sh + c;
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            kd[e] = widen1(static_cast<const QT*>(a.k_own) + o + e);
            vd[e] = widen1(static_cast<const QT*>(a.v_own) + o + e);
          }
        } else {
          widen16(kw[u], kd, ks[u], kp);
          widen16(vw[u], vd, vs[u], vp);
        }
      }
    }
  }
  __syncthreads();

  const float* kt = tile;
  const float* vt = tile + SPAN * LD;
  const float div = sqrtf(static_cast<float>(HD));
  for (int qi = warp; qi < NQ; qi += warps) {
    const int last = min(pm[qi], cap);
    if (last < s0) continue;  // warp-uniform: the span is past this query
    const int n = min(SPAN, last - s0 + 1);  // positions it sees here
    if (qi != warp) {  // the warp's first query was read up front
      load_query<QT, HD>(a, b, qi, h, qs, lane);
      __syncwarp();
    }

    float s[PER];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int r = lane + 32 * u;
      s[u] = 0.f;
      if (r < n) {
        const float4* kr = reinterpret_cast<const float4*>(kt + r * LD);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
          const float4 k = kr[c];
          const float4 qq = q4[c];
          a0 = fmaf(qq.x, k.x, a0);
          a1 = fmaf(qq.y, k.y, a1);
          a2 = fmaf(qq.z, k.z, a2);
          a3 = fmaf(qq.w, k.w, a3);
        }
        s[u] = ((a0 + a1) + (a2 + a3)) / div;
        mx = fmaxf(mx, s[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int r = lane + 32 * u;
      const float p = r < n ? expf(s[u] - mx) : 0.f;  // NaN keys stay NaN
      pv[r] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    __syncwarp();

    float* part = a.part + ((((long long)b * NQ + qi) * a.H + h) * a.nsplit +
                            split) * (HD + 2);
    if (lane < LANES) {
      float acc0[EL], acc1[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e) acc0[e] = acc1[e] = 0.f;
      const float* vl = vt + EL * lane;
      float v0[EL], v1[EL];
      int r = 0;
      for (; r + 1 < n; r += 2) {
        const float p0 = pv[r];
        const float p1 = pv[r + 1];
        load_dims(vl + r * LD, v0);
        load_dims(vl + (r + 1) * LD, v1);
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          acc0[e] = fmaf(p0, v0[e], acc0[e]);
          acc1[e] = fmaf(p1, v1[e], acc1[e]);
        }
      }
      if (r < n) {
        const float p0 = pv[r];
        load_dims(vl + r * LD, v0);
#pragma unroll
        for (int e = 0; e < EL; ++e) acc0[e] = fmaf(p0, v0[e], acc0[e]);
      }
#pragma unroll
      for (int e = 0; e < EL; ++e) part[2 + EL * lane + e] = acc0[e] + acc1[e];
    }
    if (lane == 0) {
      part[0] = mx;
      part[1] = l;
    }
    __syncwarp();  // qs and pv are the next query's
  }
}

// Pass 2: one thread per (slot, query, head, dim).
template <int HD>
__global__ void __launch_bounds__(MERGE_THREADS)
    flash_decode_merge_kernel(const float* part, const int* posmat, float* out,
                              int total, int H, int nsplit, int cap) {
  const int idx = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int d = idx % HD;
  const int bqh = idx / HD;  // (b * NQ + qi) * H + h
  const int last = min(posmat[bqh / H], cap);
  const int ns = last / SPAN + 1;
  const float* p = part + (long long)bqh * nsplit * (HD + 2);
  // MB spans' states read at once, combined in ascending order
  constexpr int MB = 8;
  float M = -INFINITY;
  for (int s0 = 0; s0 < ns; s0 += MB) {
    float m[MB];
#pragma unroll
    for (int u = 0; u < MB; ++u)
      m[u] = s0 + u < ns ? p[(s0 + u) * (HD + 2)] : -INFINITY;
#pragma unroll
    for (int u = 0; u < MB; ++u) M = fmaxf(M, m[u]);
  }
  float L = 0.f, o = 0.f;
  for (int s0 = 0; s0 < ns; s0 += MB) {
    float m[MB], l[MB], acc[MB];
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const bool in = s0 + u < ns;
      const float* q = p + (s0 + u) * (HD + 2);
      m[u] = in ? q[0] : -INFINITY;
      l[u] = in ? q[1] : 0.f;
      acc[u] = in ? q[2 + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      if (s0 + u < ns) {
        // a span that saw no position holds (-inf, 0, 0) and weighs 0
        const float e = m[u] == -INFINITY ? 0.f : expf(m[u] - M);
        L = fmaf(l[u], e, L);
        o = fmaf(acc[u], e, o);
      }
    }
  }
  out[idx] = o / fmaxf(L, 1e-30f);
}

template <typename QT, typename PT, bool OVERLAY, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Smem<PT, HD>;
  if (a.nsplit != (a.nb * a.page_size + SPAN - 1) / SPAN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = min(MAX_WARPS, max(MIN_WARPS, a.NQ));
  auto kern = flash_decode_split_kernel<QT, PT, OVERLAY, HD>;
  // once a device: allow the largest block's dynamic shared memory (the
  // 48 KB default also counts the kernel's static shared memory)
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::bytes(MAX_WARPS)));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  kern<<<dim3(a.nsplit, a.H, B), warps * 32, L::bytes(warps), stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = B * a.NQ * a.H * HD;
  flash_decode_merge_kernel<HD>
      <<<(total + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0,
         stream>>>(a.part, a.posmat, a.out, total, a.H, a.nsplit,
                   a.nb * a.page_size - 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename PT, bool OVERLAY>
int launch_hd(const Args& a, int B, int HD, cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<QT, PT, OVERLAY, 16>(a, B, stream);
    case 32:
      return launch<QT, PT, OVERLAY, 32>(a, B, stream);
    case 64:
      return launch<QT, PT, OVERLAY, 64>(a, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int launch_pages(const Args& a, int page_type, int B, int HD,
                 cudaStream_t stream) {
  switch (page_type) {
    case 0:
      return launch_hd<QT, float, false>(a, B, HD, stream);
    case 1:
      return launch_hd<QT, bf16, false>(a, B, HD, stream);
    case 2:
      return a.k_own != nullptr
                 ? launch_hd<QT, signed char, true>(a, B, HD, stream)
                 : launch_hd<QT, signed char, false>(a, B, HD, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_type: 0 f32, 1 bf16 (the overlay's k_own/v_own share it); page_type:
// 0 f32, 1 bf16, 2 int8 (k_scale/v_scale then give the f32 scale pools;
// k_own == nullptr launches it without the overlay, which the wrapper
// allows at NQ == 1 only); hd: 16, 32 or 64; nsplit = ceil(nb *
// page_size / SPAN), the scratch part's fourth dim (the wrapper's SPAN
// mirrors this file's).
// Launches the split pass, then the merge pass.  Returns a cudaError_t.
extern "C" int flash_decode(
    const void* q, int q_type, long long q_sb, long long q_sq, long long q_sh,
    const void* k_pages, const void* v_pages, int page_type,
    long long page_stride, long long pos_stride, long long head_stride,
    const float* k_scale, const float* v_scale, long long s_page_stride,
    long long s_pos_stride, long long s_head_stride, const void* k_own,
    const void* v_own, long long own_sb, long long own_sh,
    const int* tables, int nb, int page_size, const int* posmat, float* part,
    int nsplit, float* out, int B, int NQ, int H, int HD,
    void* stream) {
  const Args a{q,           q_sb,          q_sq,         q_sh,
               k_pages,     v_pages,       page_stride,  pos_stride,
               head_stride, k_scale,       v_scale,      s_page_stride,
               s_pos_stride, s_head_stride, k_own,       v_own,
               own_sb,      own_sh,        tables,       nb,
               page_size,   posmat,        part,         nsplit,
               out,         NQ,            H};
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
