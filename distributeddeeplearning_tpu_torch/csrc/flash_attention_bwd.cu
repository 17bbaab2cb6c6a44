// Flash-attention backward for Hopper (sm_90a): two kernels, in float32
// (CUDA cores) and bfloat16 (tensor cores, below).
//
// Replaces the Pallas TPU kernels distributeddeeplearning_tpu/ops/
// flash_attention.py:_bwd_dq_kernel and _bwd_dkv_kernel (launched by
// _flash_bwd_pallas).  Given the forward's inputs, its output's gradient dO,
// the saved log-sum-exp lse (nats, [B, H, S]) and delta = rowsum(dO * O)
// ([B, H, S], computed by the wrapper in PyTorch, as the TPU path computes
// it in XLA), with scale = 1/sqrt(D):
//   P  = exp(Q K^T * scale - lse)          (recomputed, never stored)
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K          dK = dS^T Q          dV = P^T dO
// The causal triangle (key <= query) is applied elementwise on the tiles
// that straddle the diagonal; tiles wholly above it are never visited.
//
// Key-padding bias.  With a non-null `bias` ([B, S] f32, 0 or -1e30 per key,
// shared by a batch row's heads) every kernel is built with HAS_BIAS and
// adds bias[b, key] to the recomputed scores, as the Pallas kernels do
// (has_bias): the dQ pass per key column of its tile, the dK/dV pass per
// key row of its transposed tile (one value a row, held in registers).  A
// masked key of a row that sees any key gets P = exp(-1e30...) = 0 exactly,
// so its dK and dV come out exactly 0.  The f32 kernels work in nats and
// take the bias times ln 2, the bf16 ones in base 2 and take it as it is;
// either way a fully masked row recomputes P = 1 from its lse, as the
// reference does.  Without a bias HAS_BIAS is false and the code is the
// unbiased kernel's.
//
// Two passes, as on the TPU.  flash_bwd_dq_kernel owns one 64-row query
// tile and loops over 32-key tiles, accumulating dQ in registers;
// flash_bwd_dkv_kernel owns one 64-key tile and loops over 32-query tiles,
// accumulating dK and dV in registers.  Every output tile has exactly one
// owner block, so the result needs no atomics and is bitwise repeatable
// from run to run (FlashAttention-2's single pass would add dQ with
// atomicAdd in an order that changes between runs).  The price is that
// both passes recompute S = Q K^T and dP = dO V^T: 14 D operations per
// visible (query, key) pair instead of the 10 D of the five products.
//
// Head dim.  Every kernel here is a template on the head dim D, built for
// D in {16, 32, 64}; the entry points take D and refuse any other value
// with cudaErrorInvalidValue.  A thread of the f32 kernels owns the D/16
// columns tx + 16 j of its rows; the bf16 kernels run D/16 k-steps over
// the head dim in their score products and keep an m64nD accumulator of
// each gradient.  At D = 64 the arithmetic is the one the kernels had
// before they took D.
//
// Layout.  q, k and v arrive as the strided [B, S, H, D] views of the
// model's qkv projection (batch, seq and head strides, last dim
// contiguous), dO likewise; they are read in place.  dQ, dK and dV are
// written [B, S, H, D] contiguous.  Rows and keys past S (the ragged last
// tile) are zero-filled on load and masked, so any S works.
//
// Bound on the H100.  At the training shape (B=8, H=12, S=2048, D=64,
// causal) the two passes read ~50 MB and write ~38 MB but do ~2.9e11
// flops (14 D per visible pair): they are bound by operations.  They use
// plain FMA on CUDA cores (67 TFLOP/s f32 peak), not TF32 mma, to keep the
// f32 parity the port is held to; the tiles live in (dynamic) shared memory
// and each thread keeps a 4 x D/16 register block of each accumulator and
// a 4 x 2 block of each score tile.  The bf16 kernels below run on wgmma
// with TMA-fed tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr int BR = 64;         // rows owned by a block (queries or keys)
constexpr int BC = 32;         // rows of the streamed tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr int LDP = BC + 1;

// Load rows [r0, r0 + rows) of a strided [S, D] head slice into smem rows
// of D + 1 floats (padded: conflict-free column reads) with float4 reads;
// rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int S, int tid) {
  for (int f = tid; f < rows * (D / 4); f += THREADS) {
    const int r = f / (D / 4);
    const int c = (f % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * stride + c);
    }
    float* row = dst + r * (D + 1) + c;
    row[0] = x.x; row[1] = x.y; row[2] = x.z; row[3] = x.w;
  }
}

struct Strides {
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
};

// dQ pass: one block per (b*h, 64-query tile); loop over 32-key tiles.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    Strides st, float* __restrict__ dq, int H, int S,
                    int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BR][LD]
  float* dOs = Qs + BR * LD;        // [BR][LD]
  float* Ks = dOs + BR * LD;        // [BC][LD]
  float* Vs = Ks + BC * LD;         // [BC][LD]
  float* dSs = Vs + BC * LD;        // [BR][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* dob = dout + b * st.do_sb + h * st.do_sh;
  load_tile<D>(Qs, qb, st.q_ss, q0, BR, S, tid);
  load_tile<D>(dOs, dob, st.do_ss, q0, BR, S, tid);

  float row_lse[4], row_delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    row_delta[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BR) : S;
  const int ntiles = (kend + BC - 1) / BC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BC;
    __syncthreads();  // previous tile consumed (and Q, dO staged)
    load_tile<D>(Ks, kb, st.k_ss, k0, BC, S, tid);
    load_tile<D>(Vs, vb, st.v_ss, k0, BC, S, tid);
    __syncthreads();

    float kb_nat[2] = {0.f, 0.f};  // this lane's two keys' bias, in nats
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c < S) {
          kb_nat[j] = __fmul_rn(bias[(long long)b * S + c], bf16mma::LN2);
        }
      }
    }

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LD + d];
        gv[i] = dOs[(ty * 4 + i) * LD + d];
      }
      const float k0v = Ks[tx * LD + d], k1v = Ks[(tx + 16) * LD + d];
      const float v0v = Vs[tx * LD + d], v1v = Vs[(tx + 16) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
        dp[i][0] = fmaf(gv[i], v0v, dp[i][0]);
        dp[i][1] = fmaf(gv[i], v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool visible = r < S && c < S && (!causal || c <= r);
        float sv = s[i][j] * scale;
        if constexpr (HAS_BIAS) sv += kb_nat[j];
        const float p = visible ? expf(sv - row_lse[i]) : 0.f;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    float* row = dq + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

// dK/dV pass: one block per (b*h, 64-key tile); loop over 32-query tiles,
// working on transposed [key, query] score tiles.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     Strides st, float* __restrict__ dk, float* __restrict__ dv,
                     int H, int S, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BR][LD]
  float* Vs = Ks + BR * LD;         // [BR][LD]
  float* Qs = Vs + BR * LD;         // [BC][LD]
  float* dOs = Qs + BC * LD;        // [BC][LD]
  float* Ps = dOs + BC * LD;        // [BR][LDP]  P^T tile
  float* dSs = Ps + BR * LDP;       // [BR][LDP]  dS^T tile
  float* Ls = dSs + BR * LDP;       // [BC] lse of the query tile
  float* Es = Ls + BC;              // [BC] delta of the query tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* dob = dout + b * st.do_sb + h * st.do_sh;
  load_tile<D>(Ks, kb, st.k_ss, k0, BR, S, tid);
  load_tile<D>(Vs, vb, st.v_ss, k0, BR, S, tid);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }
  float key_bias[4] = {0.f, 0.f, 0.f, 0.f};  // this thread's keys, in nats
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty * 4 + i;
      if (c < S) {
        key_bias[i] = __fmul_rn(bias[(long long)b * S + c], bf16mma::LN2);
      }
    }
  }

  // causal: query tiles that end before the block's first key see none of it
  const int qstart = causal ? k0 / BC : 0;
  const int ntiles = (S + BC - 1) / BC;
  for (int qt = qstart; qt < ntiles; ++qt) {
    const int q0 = qt * BC;
    __syncthreads();  // previous tile consumed (and K, V staged)
    load_tile<D>(Qs, qb, st.q_ss, q0, BC, S, tid);
    load_tile<D>(dOs, dob, st.do_ss, q0, BC, S, tid);
    if (tid < BC) {
      const int r = q0 + tid;
      Ls[tid] = r < S ? lse[(long long)bh * S + r] : 0.f;
      Es[tid] = r < S ? delta[(long long)bh * S + r] : 0.f;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * LD + d];
        vv[i] = Vs[(ty * 4 + i) * LD + d];
      }
      const float q0v = Qs[tx * LD + d], q1v = Qs[(tx + 16) * LD + d];
      const float g0v = dOs[tx * LD + d], g1v = dOs[(tx + 16) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(kv[i], q0v, s[i][0]);
        s[i][1] = fmaf(kv[i], q1v, s[i][1]);
        dp[i][0] = fmaf(vv[i], g0v, dp[i][0]);
        dp[i][1] = fmaf(vv[i], g1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty * 4 + i;  // key
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = tx + 16 * j;
        const int r = q0 + qc;  // query
        const bool visible = r < S && c < S && (!causal || c <= r);
        float sv = s[i][j] * scale;
        if constexpr (HAS_BIAS) sv += key_bias[i];
        const float p = visible ? expf(sv - Ls[qc]) : 0.f;
        Ps[(ty * 4 + i) * LDP + qc] = p;
        dSs[(ty * 4 + i) * LDP + qc] = p * (dp[i][j] - Es[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float pv[4], dsv[4], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * LDP + c];
        dsv[i] = dSs[(ty * 4 + i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = dOs[c * LD + tx + 16 * j];
        qv[j] = Qs[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= S) continue;
    const long long off = (((long long)b * S + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BC * (D + 1) + BR * LDP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * BR * (D + 1) + 2 * BC * (D + 1) + 2 * BR * LDP + 2 * BC);
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <int D, bool HAS_BIAS>
int launch_dq_f32_as(const float* q, const float* k, const float* v,
                     const float* bias, const float* dout, const float* lse,
                     const float* delta, const Strides& st, float* dq, int B,
                     int H, int S, int causal, float scale,
                     cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for explicitly
  constexpr size_t smem = dq_smem<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + BR - 1) / BR, B * H);
  flash_bwd_dq_kernel<D, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, dout, lse, delta, st, dq, H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_f32(const float* q, const float* k, const float* v,
                  const float* bias, const float* dout, const float* lse,
                  const float* delta, const Strides& st, float* dq, int B,
                  int H, int S, int causal, float scale, cudaStream_t stream) {
  return bias != nullptr
             ? launch_dq_f32_as<D, true>(q, k, v, bias, dout, lse, delta, st,
                                         dq, B, H, S, causal, scale, stream)
             : launch_dq_f32_as<D, false>(q, k, v, bias, dout, lse, delta, st,
                                          dq, B, H, S, causal, scale, stream);
}

template <int D, bool HAS_BIAS>
int launch_dkv_f32_as(const float* q, const float* k, const float* v,
                      const float* bias, const float* dout, const float* lse,
                      const float* delta, const Strides& st, float* dk,
                      float* dv, int B, int H, int S, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + BR - 1) / BR, B * H);
  flash_bwd_dkv_kernel<D, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, dout, lse, delta, st, dk, dv, H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const float* q, const float* k, const float* v,
                   const float* bias, const float* dout, const float* lse,
                   const float* delta, const Strides& st, float* dk,
                   float* dv, int B, int H, int S, int causal, float scale,
                   cudaStream_t stream) {
  return bias != nullptr
             ? launch_dkv_f32_as<D, true>(q, k, v, bias, dout, lse, delta, st,
                                          dk, dv, B, H, S, causal, scale,
                                          stream)
             : launch_dkv_f32_as<D, false>(q, k, v, bias, dout, lse, delta,
                                           st, dk, dv, B, H, S, causal, scale,
                                           stream);
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and dO in that order;
// bias: [B, S] f32 or null (no key-padding mask).
extern "C" int flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout,
    const float* lse, const float* delta, const long long* strides,
    float* dq, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const Strides st = make_strides(strides);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dq_f32<16>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                               S, causal, scale, cs);
    case 32:
      return launch_dq_f32<32>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                               S, causal, scale, cs);
    case 64:
      return launch_dq_f32<64>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                               S, causal, scale, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout,
    const float* lse, const float* delta, const long long* strides,
    float* dk, float* dv, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const Strides st = make_strides(strides);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dkv_f32<16>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                B, H, S, causal, scale, cs);
    case 32:
      return launch_dkv_f32<32>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                B, H, S, causal, scale, cs);
    case 64:
      return launch_dkv_f32<64>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                B, H, S, causal, scale, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on Hopper's tensor cores: the same two passes for bf16 q, k,
// v and dO, with the Pallas kernels' rounding points.  S = Q K^T and
// dP = dO V^T accumulate in f32; P = exp2(S * scale * log2 e + bias -
// lse * log2 e) and dS = P * (dP - delta) * scale are f32; dS is rounded to
// bf16 as the operand of dS K and dS^T Q, P as the operand of P^T dO; dQ, dK
// and dV accumulate in f32 and are rounded to bf16 once at the end.  They
// replace the bf16 forms of the Pallas _bwd_dq_kernel and _bwd_dkv_kernel;
// an earlier version ran every product as a warp's mma.sync on cp.async
// tiles, waited for each tile before using it and masked every element.
//
// Design (warp-specialised, built from csrc/hopper.cuh as the bf16 forward
// is).  One block per (b*h, tile of 64 * NC owned rows: queries in the dQ
// pass, keys in the dK/dV pass).  Warpgroup 0 is the producer: it gives
// back registers (setmaxnreg.dec) and one thread issues TMA loads -- the
// block's own two tiles once, then each 64-row tile of the streamed pair
// into a ring of STAGES16 = 2 stages, each guarded by a full and an empty
// mbarrier.  Warpgroups 1..NC are consumers (setmaxnreg.inc), each owning
// 64 rows, with every accumulator in registers.
// - dQ pass: owns Q and dO; streams K and V (and, with HAS_BIAS, the tile's
//   key bias).  Per tile: S = Q K^T and dP = dO V^T as two wgmma m64n64k16
//   products from shared memory (both K-major), in flight together before
//   one wait; P and dS in registers, dS rounded pairwise into the register
//   A operand; dQ += dS K as wgmma m64nDk16 with K read MN-major (the
//   transpose bit) from the tile that fed S.  lse and delta of a thread's
//   two rows are read once.
// - dK/dV pass: owns K and V (and each key row's bias, in registers);
//   streams 64-query tiles of Q and dO with the tile's 64 lse and 64 delta
//   values.  Per tile: S^T = K Q^T and dP^T = V dO^T as two SS products;
//   P^T and dS^T in registers, both rounded into A operands; dV += P^T dO
//   and dK += dS^T Q as RS products with dO and Q read MN-major from the
//   tiles that fed the first two.
// The tensor maps span exactly the [B, S, H, D] views (read in place, any
// strides a multiple of 16 bytes), TMA writes zeros for rows past S, and
// stores skip rows past S.  The per-row f32 values of a streamed tile (lse,
// delta, the bias) come as 1-D windows of WIN = 68 floats from a 16-byte
// aligned start (a TMA box must start on 16 bytes in its innermost
// dimension), so any S works.
//
// Masks.  Only a tile that crosses the causal diagonal of the warpgroup's
// rows, or runs past S, is masked elementwise (P = 0 by a select, so an
// inf from an unmatched lse never reaches a product); interior tiles run no
// masking code.  A tile wholly outside a warpgroup's causal triangle is not
// computed by it -- it waits for the tile and releases it, so the ring stays
// in step for the others.  The dQ pass stops its stream at the block's last
// query row; the dK/dV pass starts it at the block's first key.  Both issue
// their heaviest blocks first: the dQ pass's last query tiles, the dK/dV
// pass's first key tiles (the grid's slow dimension).
//
// Determinism.  Every output element has one owner warpgroup, which sums
// its tiles in a fixed order: no atomics and no second reduction, so dQ, dK
// and dV are bitwise equal from launch to launch, as the reference's two
// Pallas passes are.  The price of two passes is that both recompute S and
// dP: 14 D flops a visible pair against the 10 D of a single pass that adds
// dQ with atomics.
//
// Bound on the H100.  At the training shape (B=8, H=12, S=2048, D=64,
// causal) the dQ pass does 6 D flops a visible pair (S, dP, dS K) and the
// dK/dV pass 8 D (S, dP, P^T dO, dS^T Q): ~0.078 ms and ~0.104 ms at the
// 989 TFLOP/s dense bf16 peak, above the ~0.03 ms their bytes take: bound
// by operations.  wgmma is the only way to the tensor cores' full rate; the
// ring overlaps the copy of tile i+1 with the products of tile i; NC
// warpgroups share each streamed tile from shared memory; at D = 64 the
// SFU's exp2 of a score costs about what its products do, and the other
// warpgroups of a block run their products in between.
//
// Choices, each timed against the others in one call on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_flash.py; the readings are in PERF.md):
// at the training shape the dQ pass took 0.190 ms with 192-row blocks
// against 0.222 with 128 and 0.212 with 64; the dK/dV pass 0.280 with 128
// against 0.387 with 192 (it spills there) and 0.450 with 64.  Running the
// exponentials of S while the dP product is in flight (and dS beside the dV
// product) gained nothing in the dQ pass and cost the dK/dV pass 14%
// (0.320: more live registers, spills), so each tile runs serially:
// products, wait, elementwise work, products, wait.
//
// Registers.  ptxas compiles a whole instance within its launch bound --
// 128 a thread with one consumer warpgroup (two blocks an SM) and with
// three (512 threads), 168 with two -- whatever setmaxnreg later hands the
// consumers (232, 240 or 160; the producer keeps 24).  The dK/dV pass holds
// S^T, dP^T, dK and dV (32 floats each at D = 64) plus both A operands: at
// D = 64 it spills ~400 bytes under a 128 cap and none under 168, so it
// never takes 192-row blocks and spills only in its 64-row instances (the
// smallest grids).  Each instance checks its launch register count against
// its setmaxnreg counts and refuses to launch (cudaError 9) rather than
// wait in setmaxnreg.inc.  The launcher picks the rows from the grid
// against the SM count (bwd_bf16_block_rows), per pass.

namespace {

using bf16mma::bf16;
using hopper::exp2_ftz;

constexpr int WG16 = 128;     // threads of a warpgroup
constexpr int ROWS16 = 64;    // rows of every tile (owned or streamed)
constexpr int STAGES16 = 2;   // depth of the ring
// a streamed tile's per-row f32 values (lse, delta or bias): ROWS16 of them
// from a 16-byte aligned start, so up to 3 floats before the tile's first
constexpr int WIN = ROWS16 + 4;
constexpr int WIN_BYTES = (WIN * 4 + 127) / 128 * 128;  // a stage's window

template <int D, int NC>
struct BwdShape {
  static constexpr int ROW = D * 2;          // bytes of a head row
  static constexpr int TILE = ROWS16 * ROW;  // bytes of a 64-row tile
  static constexpr int THREADS = WG16 * (NC + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : NC == 2 ? 240 : 160;
  static constexpr int POOL = WG16 * (PRODUCER_REGS + NC * CONSUMER_REGS);
};

// dQ pass: Q tiles, dO tiles (NC each), then the K and V rings, the bias
// windows and the barriers; every tile on 1024 bytes
template <int D, bool HAS_BIAS, int NC>
struct DqLayout : BwdShape<D, NC> {
  using Base = BwdShape<D, NC>;
  static constexpr int DO_OFF = NC * Base::TILE;
  static constexpr int K_OFF = 2 * NC * Base::TILE;
  static constexpr int V_OFF = K_OFF + STAGES16 * Base::TILE;
  static constexpr int BIAS_OFF = V_OFF + STAGES16 * Base::TILE;
  static constexpr int BAR_OFF = BIAS_OFF + (HAS_BIAS ? STAGES16 * WIN_BYTES : 0);
  // + slack to align the dynamic shared memory's start to 1024 bytes
  static constexpr int BYTES = BAR_OFF + (2 * STAGES16 + 1) * 8 + 1024;
};

// dK/dV pass: K tiles, V tiles (NC each), then the Q and dO rings, the lse
// and delta windows and the barriers
template <int D, int NC>
struct DkvLayout : BwdShape<D, NC> {
  using Base = BwdShape<D, NC>;
  static constexpr int V_OFF = NC * Base::TILE;
  static constexpr int Q_OFF = 2 * NC * Base::TILE;
  static constexpr int DO_OFF = Q_OFF + STAGES16 * Base::TILE;
  static constexpr int LSE_OFF = DO_OFF + STAGES16 * Base::TILE;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES16 * WIN_BYTES;
  static constexpr int BAR_OFF = DELTA_OFF + STAGES16 * WIN_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES16 + 1) * 8 + 1024;
};

// dS of one 64 x 64 [query, key] tile of the dQ pass into its A operand.
// EDGE: the tile crosses the causal diagonal or S, so each element checks
// that its key is visible from its row; rows past S are never stored.
template <bool HAS_BIAS, bool EDGE>
__device__ __forceinline__ void dq_tile(const float (&sc)[32],
                                        const float (&dp)[32],
                                        uint32_t (&da)[4][4],
                                        const float (&lse2)[2],
                                        const float (&dlt)[2],
                                        const float* bias_tile,
                                        float scale_log2, float scale, int k0,
                                        int row, int t, int S, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = 8 * j + 2 * t + (e & 1);  // key within the tile
      // with the bias: a fully masked row's -1e30 cancels its lse exactly
      // (P = 1, as in the reference); without: one fused multiply-add
      const float x = HAS_BIAS ? sc[4 * j + e] * scale_log2 + bias_tile[c] - lse2[i]
                               : fmaf(sc[4 * j + e], scale_log2, -lse2[i]);
      float p = exp2_ftz(x);
      if constexpr (EDGE) {
        const int key = k0 + c;
        if (key >= S || (causal && key > row + 8 * i)) p = 0.f;
      }
      ds[e] = p * (dp[4 * j + e] - dlt[i]) * scale;
    }
    hopper::pack_a(da, j, ds);
  }
}

// P^T and dS^T of one 64 x 64 [key, query] tile of the dK/dV pass into
// their A operands; the tile's lse (nats) and delta come from its windows.
// EDGE: the tile crosses the causal diagonal or S; key rows past S are
// never stored.
template <bool HAS_BIAS, bool EDGE>
__device__ __forceinline__ void dkv_tile(const float (&st)[32],
                                         const float (&dpt)[32],
                                         uint32_t (&pa)[4][4],
                                         uint32_t (&da)[4][4],
                                         const float (&kbias)[2],
                                         const float* lse_w,
                                         const float* delta_w,
                                         float scale_log2, float scale, int q0,
                                         int key, int t, int S, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;  // the first of this lane's two queries
    // lse in base 2, the product rounded (__fmul_rn: never fused into the
    // subtraction), so a fully masked row's -1e30 * ln 2 comes back to
    // exactly the -1e30 its biased scores carry
    const float l2[2] = {__fmul_rn(lse_w[c], bf16mma::LOG2E),
                         __fmul_rn(lse_w[c + 1], bf16mma::LOG2E)};
    const float dl[2] = {delta_w[c], delta_w[c + 1]};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;  // key row key + 8 i
      const int u = e & 1;   // query c + u
      const float x = HAS_BIAS ? st[4 * j + e] * scale_log2 + kbias[i] - l2[u]
                               : fmaf(st[4 * j + e], scale_log2, -l2[u]);
      float pv = exp2_ftz(x);
      if constexpr (EDGE) {
        const int q = q0 + c + u;
        if (q >= S || (causal && key + 8 * i > q)) pv = 0.f;
      }
      p[e] = pv;
      ds[e] = pv * (dpt[4 * j + e] - dl[u]) * scale;
    }
    hopper::pack_a(pa, j, p);
    hopper::pack_a(da, j, ds);
  }
}

// this thread's two rows (row, row + 8) of a [B, S, H, D] bf16 output from
// an m64nD accumulator
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           int b, int h, int H, int S, int row,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    bf16* orow = out + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D, bool HAS_BIAS, int NC>
__global__ void __launch_bounds__(WG16 * (NC + 1), NC == 1 ? 2 : 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_bias,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int S, int causal,
                         float scale) {
  namespace hp = hopper;
  using L = DqLayout<D, HAS_BIAS, NC>;
  constexpr int BQ = ROWS16 * NC;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* Bs = reinterpret_cast<float*>(smem + L::BIAS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES16;
  uint64_t* own = empty + STAGES16;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last query tile first
  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + ROWS16 - 1) / ROWS16;
  const int wg = threadIdx.x / WG16;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES16; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], NC);
    }
    hp::mbar_init(own, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    hp::reg_dealloc<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hp::prefetch_tensormap(&tm_q);
      hp::prefetch_tensormap(&tm_k);
      hp::prefetch_tensormap(&tm_v);
      hp::prefetch_tensormap(&tm_do);
      if constexpr (HAS_BIAS) hp::prefetch_tensormap(&tm_bias);
      // the warpgroups' Q and dO boxes that hold a row below S
      const int nq = min(NC, (S - q0 + ROWS16 - 1) / ROWS16);
      hp::mbar_arrive_expect_tx(own, 2 * nq * L::TILE);
      for (int i = 0; i < nq; ++i) {
        hp::tma_load_4d(Qs + i * ROWS16 * D, &tm_q, own, 0, h, q0 + i * ROWS16, b);
        hp::tma_load_4d(dOs + i * ROWS16 * D, &tm_do, own, 0, h, q0 + i * ROWS16, b);
      }
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % STAGES16;
        // the stage's previous tile released by every consumer
        if (kt >= STAGES16) hp::mbar_wait(&empty[s], ((kt / STAGES16) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], 2 * L::TILE + (HAS_BIAS ? WIN * 4 : 0));
        hp::tma_load_4d(Ks + s * ROWS16 * D, &tm_k, &full[s], 0, h, kt * ROWS16, b);
        hp::tma_load_4d(Vs + s * ROWS16 * D, &tm_v, &full[s], 0, h, kt * ROWS16, b);
        if constexpr (HAS_BIAS) {
          hp::tma_load_1d(Bs + s * (WIN_BYTES / 4), &tm_bias, &full[s],
                          (b * S + kt * ROWS16) & ~3);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    hp::reg_alloc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * WG16;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + c * ROWS16;      // the warpgroup's first row
    const int row = r0 + warp * 16 + g;  // this thread's rows: row, row + 8
    const uint32_t q_addr = hp::smem_u32(Qs + c * ROWS16 * D);
    const uint32_t do_addr = hp::smem_u32(dOs + c * ROWS16 * D);
    const uint32_t k_addr = hp::smem_u32(Ks);
    const uint32_t v_addr = hp::smem_u32(Vs);
    const float scale_log2 = scale * bf16mma::LOG2E;
    // the tiles this warpgroup computes come first: with causal masking,
    // those that start at or before its last row; it releases the rest
    const int nact = r0 >= S ? 0
                     : causal ? min(ntiles, (r0 + ROWS16 - 1) / ROWS16 + 1)
                              : ntiles;

    // lse in base 2, the product rounded (see dkv_tile), and delta
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      const long long at = (long long)blockIdx.x * S + r;
      lse2[i] = r < S ? __fmul_rn(lse[at], bf16mma::LOG2E) : 0.f;
      dlt[i] = r < S ? delta[at] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[ROWS16 / 2], dp[ROWS16 / 2];
    uint32_t da[ROWS16 / 16][4];
    if (nact > 0) hp::mbar_wait(own, 0);

    for (int kt = 0; kt < nact; ++kt) {
      const int s = kt % STAGES16;
      const int k0 = kt * ROWS16;
      const uint32_t k_tile = k_addr + s * L::TILE;
      hp::mbar_wait(&full[s], (kt / STAGES16) & 1);
      hp::fence();
      hp::ss_k_major<L::ROW, ROWS16>(sc, q_addr, k_tile);
      hp::ss_k_major<L::ROW, ROWS16>(dp, do_addr, v_addr + s * L::TILE);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(sc);
      hp::fence_operand(dp);
      // this tile's bias, from its stage's 16-byte aligned window
      const float* bias_tile = Bs + s * (WIN_BYTES / 4) + ((b * S + k0) & 3);
      if (k0 + ROWS16 > S || (causal && k0 + ROWS16 - 1 > r0)) {
        dq_tile<HAS_BIAS, true>(sc, dp, da, lse2, dlt, bias_tile, scale_log2,
                                scale, k0, row, t, S, causal);
      } else {
        dq_tile<HAS_BIAS, false>(sc, dp, da, lse2, dlt, bias_tile, scale_log2,
                                 scale, k0, row, t, S, causal);
      }
      hp::fence();
      hp::rs_mn_major<L::ROW, ROWS16>(acc, da, k_tile);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(acc);
      hp::fence_operand(da);
      if (tid == 0) hp::mbar_arrive(&empty[s]);  // its products retired
    }
    for (int kt = nact; kt < ntiles; ++kt) {  // tiles wholly above its rows
      const int s = kt % STAGES16;
      hp::mbar_wait(&full[s], (kt / STAGES16) & 1);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
    }
    store_rows<D>(dq, acc, b, h, H, S, row, t);
  }
}

template <int D, bool HAS_BIAS, int NC>
__global__ void __launch_bounds__(WG16 * (NC + 1), NC == 1 ? 2 : 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta,
                          const float* __restrict__ bias,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int S, int causal, float scale) {
  namespace hp = hopper;
  using L = DkvLayout<D, NC>;
  constexpr int BK = ROWS16 * NC;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  float* Ls = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* Es = reinterpret_cast<float*>(smem + L::DELTA_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES16;
  uint64_t* own = empty + STAGES16;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BK;  // first key tile first: the longest blocks
  // causal: query tiles that end before the block's first key see none of it
  const int qstart = causal ? k0 / ROWS16 : 0;
  const int ntiles = (S + ROWS16 - 1) / ROWS16 - qstart;
  const int wg = threadIdx.x / WG16;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES16; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], NC);
    }
    hp::mbar_init(own, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    hp::reg_dealloc<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hp::prefetch_tensormap(&tm_q);
      hp::prefetch_tensormap(&tm_k);
      hp::prefetch_tensormap(&tm_v);
      hp::prefetch_tensormap(&tm_do);
      hp::prefetch_tensormap(&tm_lse);
      hp::prefetch_tensormap(&tm_delta);
      // the warpgroups' K and V boxes that hold a key below S
      const int nk = min(NC, (S - k0 + ROWS16 - 1) / ROWS16);
      hp::mbar_arrive_expect_tx(own, 2 * nk * L::TILE);
      for (int i = 0; i < nk; ++i) {
        hp::tma_load_4d(Ks + i * ROWS16 * D, &tm_k, own, 0, h, k0 + i * ROWS16, b);
        hp::tma_load_4d(Vs + i * ROWS16 * D, &tm_v, own, 0, h, k0 + i * ROWS16, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES16;
        const int q0 = (qstart + it) * ROWS16;
        if (it >= STAGES16) hp::mbar_wait(&empty[s], ((it / STAGES16) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], 2 * L::TILE + 2 * WIN * 4);
        hp::tma_load_4d(Qs + s * ROWS16 * D, &tm_q, &full[s], 0, h, q0, b);
        hp::tma_load_4d(dOs + s * ROWS16 * D, &tm_do, &full[s], 0, h, q0, b);
        const int w0 = (bh * S + q0) & ~3;
        hp::tma_load_1d(Ls + s * (WIN_BYTES / 4), &tm_lse, &full[s], w0);
        hp::tma_load_1d(Es + s * (WIN_BYTES / 4), &tm_delta, &full[s], w0);
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup ----
    hp::reg_alloc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * WG16;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kk0 = k0 + c * ROWS16;     // the warpgroup's first key
    const int key = kk0 + warp * 16 + g; // this thread's keys: key, key + 8
    const uint32_t k_addr = hp::smem_u32(Ks + c * ROWS16 * D);
    const uint32_t v_addr = hp::smem_u32(Vs + c * ROWS16 * D);
    const uint32_t q_addr = hp::smem_u32(Qs);
    const uint32_t do_addr = hp::smem_u32(dOs);
    const float scale_log2 = scale * bf16mma::LOG2E;
    // with causal masking the first c tiles end before the warpgroup's
    // first key: it releases them, then computes the rest
    const int skip = kk0 >= S ? ntiles : causal ? c : 0;

    float kbias[2] = {0.f, 0.f};  // this thread's keys' bias, base 2
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (key + 8 * i < S) kbias[i] = bias[(long long)b * S + key + 8 * i];
      }
    }
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    float st[ROWS16 / 2], dpt[ROWS16 / 2];
    uint32_t pa[ROWS16 / 16][4], da[ROWS16 / 16][4];

    for (int it = 0; it < skip; ++it) {
      const int s = it % STAGES16;
      hp::mbar_wait(&full[s], (it / STAGES16) & 1);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
    }
    if (skip < ntiles) hp::mbar_wait(own, 0);
    for (int it = skip; it < ntiles; ++it) {
      const int s = it % STAGES16;
      const int q0 = (qstart + it) * ROWS16;
      const uint32_t q_tile = q_addr + s * L::TILE;
      const uint32_t do_tile = do_addr + s * L::TILE;
      hp::mbar_wait(&full[s], (it / STAGES16) & 1);
      hp::fence();
      hp::ss_k_major<L::ROW, ROWS16>(st, k_addr, q_tile);
      hp::ss_k_major<L::ROW, ROWS16>(dpt, v_addr, do_tile);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(st);
      hp::fence_operand(dpt);
      const int off = (bh * S + q0) & 3;  // the tile's start in its windows
      const float* lse_w = Ls + s * (WIN_BYTES / 4) + off;
      const float* delta_w = Es + s * (WIN_BYTES / 4) + off;
      if (q0 + ROWS16 > S || (causal && q0 < kk0 + ROWS16 - 1)) {
        dkv_tile<HAS_BIAS, true>(st, dpt, pa, da, kbias, lse_w, delta_w,
                                 scale_log2, scale, q0, key, t, S, causal);
      } else {
        dkv_tile<HAS_BIAS, false>(st, dpt, pa, da, kbias, lse_w, delta_w,
                                  scale_log2, scale, q0, key, t, S, causal);
      }
      hp::fence();
      hp::rs_mn_major<L::ROW, ROWS16>(dv_acc, pa, do_tile);
      hp::rs_mn_major<L::ROW, ROWS16>(dk_acc, da, q_tile);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(dv_acc);
      hp::fence_operand(dk_acc);
      hp::fence_operand(pa);
      hp::fence_operand(da);
      if (tid == 0) hp::mbar_arrive(&empty[s]);  // its products retired
    }
    store_rows<D>(dk, dk_acc, b, h, H, S, key, t);
    store_rows<D>(dv, dv_acc, b, h, H, S, key, t);
  }
}

// Rows a block owns in pass `pass` (0: dQ, 1: dK/dV): 192 (dQ only), 128
// or 64 (see the note above)
int bwd_bf16_block_rows(int pass, int B, int H, int S) {
  return hopper::block_rows(B, H, S, pass == 0 ? 192 : 128);
}

// the four [B, S, H, D] maps of a call (q, k, v, dO: 64-row boxes)
template <int D>
bool encode_operands(CUtensorMap* maps, const void* q, const void* k,
                     const void* v, const void* dout, const Strides& st, int B,
                     int H, int S) {
  using hopper::encode_rows;
  return encode_rows<D>(&maps[0], q, st.q_sb, st.q_ss, st.q_sh, B, H, S, ROWS16) &&
         encode_rows<D>(&maps[1], k, st.k_sb, st.k_ss, st.k_sh, B, H, S, ROWS16) &&
         encode_rows<D>(&maps[2], v, st.v_sb, st.v_ss, st.v_sh, B, H, S, ROWS16) &&
         encode_rows<D>(&maps[3], dout, st.do_sb, st.do_ss, st.do_sh, B, H, S,
                        ROWS16);
}

template <int D, bool HAS_BIAS, int NC>
int launch_dq_bf16_as(const CUtensorMap (&maps)[5], const float* lse,
                      const float* delta, void* dq, int B, int H, int S,
                      int causal, float scale, cudaStream_t stream) {
  using L = DqLayout<D, HAS_BIAS, NC>;
  const auto kernel = flash_bwd_dq_bf16_kernel<D, HAS_BIAS, NC>;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = hopper::configure_once(kernel, L::BYTES, L::THREADS,
                                                 L::POOL, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + ROWS16 * NC - 1) / (ROWS16 * NC));
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, delta,
      static_cast<bf16*>(dq), H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool HAS_BIAS, int NC>
int launch_dkv_bf16_as(const CUtensorMap (&maps)[6], const float* bias,
                       void* dk, void* dv, int B, int H, int S, int causal,
                       float scale, cudaStream_t stream) {
  using L = DkvLayout<D, NC>;
  const auto kernel = flash_bwd_dkv_bf16_kernel<D, HAS_BIAS, NC>;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = hopper::configure_once(kernel, L::BYTES, L::THREADS,
                                                 L::POOL, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + ROWS16 * NC - 1) / (ROWS16 * NC));
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], bias,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, const Strides& st, void* dq, int B,
                   int H, int S, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap maps[5];
  memset(&maps[4], 0, sizeof(CUtensorMap));
  bool ok = encode_operands<D>(maps, q, k, v, dout, st, B, H, S);
  if (bias != nullptr) {
    // the [B, S] bias as one run of B*S floats: a tile of row b starts at
    // b*S + k0, its window 0-3 floats before
    ok = ok && hopper::encode_window(&maps[4], bias, (long long)B * S, WIN);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = bwd_bf16_block_rows(0, B, H, S) / ROWS16;
  const bool has_bias = bias != nullptr;
#define DQ_AS(HB, NC_) \
  launch_dq_bf16_as<D, HB, NC_>(maps, lse, delta, dq, B, H, S, causal, scale, stream)
  if (nc == 3) return has_bias ? DQ_AS(true, 3) : DQ_AS(false, 3);
  if (nc == 2) return has_bias ? DQ_AS(true, 2) : DQ_AS(false, 2);
  return has_bias ? DQ_AS(true, 1) : DQ_AS(false, 1);
#undef DQ_AS
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, const Strides& st, void* dk, void* dv,
                    int B, int H, int S, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap maps[6];
  // lse and delta, [B, H, S] each, as runs of B*H*S floats: a query tile of
  // head bh starts at bh*S + q0, its window 0-3 floats before
  const long long n = (long long)B * H * S;
  const bool ok = encode_operands<D>(maps, q, k, v, dout, st, B, H, S) &&
                  hopper::encode_window(&maps[4], lse, n, WIN) &&
                  hopper::encode_window(&maps[5], delta, n, WIN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = bwd_bf16_block_rows(1, B, H, S) / ROWS16;
  const bool has_bias = bias != nullptr;
#define DKV_AS(HB, NC_) \
  launch_dkv_bf16_as<D, HB, NC_>(maps, bias, dk, dv, B, H, S, causal, scale, stream)
  if (nc == 2) return has_bias ? DKV_AS(true, 2) : DKV_AS(false, 2);
  return has_bias ? DKV_AS(true, 1) : DKV_AS(false, 1);
#undef DKV_AS
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and dO in that order;
// bias: [B, S] f32 or null.  lse and delta: [B, H, S] f32, 16-byte aligned.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout,
    const float* lse, const float* delta, const long long* strides,
    void* dq, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const Strides st = make_strides(strides);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dq_bf16<16>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                                S, causal, scale, cs);
    case 32:
      return launch_dq_bf16<32>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                                S, causal, scale, cs);
    case 64:
      return launch_dq_bf16<64>(q, k, v, bias, dout, lse, delta, st, dq, B, H,
                                S, causal, scale, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout,
    const float* lse, const float* delta, const long long* strides,
    void* dk, void* dv, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const Strides st = make_strides(strides);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dkv_bf16<16>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                 B, H, S, causal, scale, cs);
    case 32:
      return launch_dkv_bf16<32>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                 B, H, S, causal, scale, cs);
    case 64:
      return launch_dkv_bf16<64>(q, k, v, bias, dout, lse, delta, st, dk, dv,
                                 B, H, S, causal, scale, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The rows a block of the bf16 backward's pass `pass` (0: dQ, 1: dK/dV)
// owns at (B, H, S) on the current device: 192, 128 or 64 (see
// bwd_bf16_block_rows).
extern "C" int flash_attention_bwd_bf16_block_rows(int pass, int B, int H,
                                                   int S) {
  return bwd_bf16_block_rows(pass, B, H, S);
}

// Dynamic shared memory, in bytes, of a bf16 backward instance: pass 0 the
// dQ pass, 1 the dK/dV pass, head dim D, with or without the bias, at
// `rows` owned rows a block; -1 if there is no such instance.
extern "C" int flash_attention_bwd_bf16_smem_bytes(int pass, int D,
                                                   int has_bias, int rows) {
  const int nc = rows / ROWS16;
  if (rows % ROWS16 != 0 || nc < 1 || nc > (pass == 0 ? 3 : 2) ||
      (pass != 0 && pass != 1) || (D != 16 && D != 32 && D != 64)) {
    return -1;
  }
  const int di = D == 16 ? 0 : D == 32 ? 1 : 2;
  if (pass == 1) {
    const int dkv[3][2] = {{DkvLayout<16, 1>::BYTES, DkvLayout<16, 2>::BYTES},
                           {DkvLayout<32, 1>::BYTES, DkvLayout<32, 2>::BYTES},
                           {DkvLayout<64, 1>::BYTES, DkvLayout<64, 2>::BYTES}};
    return dkv[di][nc - 1];
  }
  const int dq[3][3][2] = {
      {{DqLayout<16, false, 1>::BYTES, DqLayout<16, true, 1>::BYTES},
       {DqLayout<16, false, 2>::BYTES, DqLayout<16, true, 2>::BYTES},
       {DqLayout<16, false, 3>::BYTES, DqLayout<16, true, 3>::BYTES}},
      {{DqLayout<32, false, 1>::BYTES, DqLayout<32, true, 1>::BYTES},
       {DqLayout<32, false, 2>::BYTES, DqLayout<32, true, 2>::BYTES},
       {DqLayout<32, false, 3>::BYTES, DqLayout<32, true, 3>::BYTES}},
      {{DqLayout<64, false, 1>::BYTES, DqLayout<64, true, 1>::BYTES},
       {DqLayout<64, false, 2>::BYTES, DqLayout<64, true, 2>::BYTES},
       {DqLayout<64, false, 3>::BYTES, DqLayout<64, true, 3>::BYTES}}};
  return dq[di][nc - 1][has_bias ? 1 : 0];
}
