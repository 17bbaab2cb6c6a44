// Flash-attention backward, float32, for Hopper (sm_90a): two kernels.
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
// the head dim and keep D/8 n-tiles of each gradient.  At D = 64 the
// arithmetic is the one the kernels had before they took D.
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
// a 4 x 2 block of each score tile.  wgmma, TMA pipelining and bf16 are
// later work.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

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
// bf16 backward on the tensor cores: the same two passes for bf16 q, k, v and
// dO, with the Pallas kernels' rounding points.  S = Q K^T and dP = dO V^T
// accumulate in f32; P = exp2(S * scale * log2 e - lse * log2 e) and
// dS = P * (dP - delta) * scale are f32; dS is rounded to bf16 as the operand
// of dS K and dS^T Q, P as the operand of P^T dO; dQ, dK and dV accumulate in
// f32 and are rounded to bf16 once at the end.
//
// Design.  Blocks of 4 warps, every product an mma.sync m16n8k16 bf16 with
// its B operand read from shared memory by ldmatrix.  The pass's own tile
// (its A operands) sits in registers for the whole loop; the streamed tile
// is staged with cp.async.  A score or gradient accumulator becomes the A
// operand of the next product in registers (a_from_c), so neither P nor dS
// is written to shared memory.
// - dQ pass: one block per (b*h, 64-query tile), 16 queries a warp, Q and dO
//   fragments in registers; loop over 64-key tiles: S and dP (16 x 64 each),
//   then dQ += bf16(dS) K (K read .trans).
// - dK/dV pass: one block per (b*h, 64-key tile), 16 keys a warp, K and V
//   fragments in registers; loop over 32-query tiles on transposed tiles:
//   S^T = K Q^T and dP^T = V dO^T (16 x 32), then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q (dO and Q read .trans).  The 32-query tile keeps the
//   four accumulators (S^T, dP^T, dK, dV) within the register file.
// Causal: the dQ pass stops at its diagonal tile, the dK/dV pass starts at
// the first query tile that reaches its keys, and a warp skips tiles wholly
// outside its triangle; visited tiles are masked elementwise (P = 0).
//
// Bound on the H100.  At the training shape (B=8, H=12, S=2048, D=64,
// causal) the dQ pass does 6 D flops a visible pair (S, dP, dS K) and the
// dK/dV pass 8 D (S, dP, P^T dO, dS^T Q): ~0.08 ms and ~0.10 ms at the
// 989 TFLOP/s dense bf16 peak, above the ~0.03 ms their bytes take.

namespace {

using bf16mma::bf16;

constexpr int BR16 = 64;        // rows a block owns (queries or keys)
constexpr int BKQ16 = 64;       // keys a tile of the dQ pass
constexpr int BQK16 = 32;       // queries a tile of the dK/dV pass
constexpr int THREADS16 = 128;  // 4 warps, 16 owned rows each

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS16)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Strides st,
                         bf16* __restrict__ dq, int H, int S, int causal,
                         float scale) {
  namespace m = bf16mma;
  constexpr int LDS = m::Tile<D>::LDS;
  constexpr int KD = D / 16;  // k-steps over the head dim
  __shared__ __align__(16) bf16 Qs[BR16 * LDS];
  __shared__ __align__(16) bf16 dOs[BR16 * LDS];
  __shared__ __align__(16) bf16 Ks[BKQ16 * LDS];
  __shared__ __align__(16) bf16 Vs[BKQ16 * LDS];
  __shared__ float Bs[HAS_BIAS ? BKQ16 : 1];  // the K tile's key bias

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BR16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + warp * 16;
  const float scale_log2 = scale * m::LOG2E;

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  const bf16* dob = dout + b * st.do_sb + h * st.do_sh;
  m::load_tile_async<BR16, THREADS16, D>(Qs, qb, st.q_ss, q0, S, tid);
  m::load_tile_async<BR16, THREADS16, D>(dOs, dob, st.do_ss, q0, S, tid);
  m::cp_async_commit();

  // lse in base 2, the product rounded (__fmul_rn: no fused multiply-add
  // with the subtraction below), so a fully masked row's -1e30 * ln 2
  // comes back to exactly the -1e30 its biased scores carry, as in the
  // reference
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + i * 8;
    row_lse[i] =
        r < S ? __fmul_rn(lse[(long long)bh * S + r], m::LOG2E) : 0.f;
    row_delta[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
  }
  m::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4], gf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    m::ldsm_x4(qf[kk], m::a_addr<LDS>(Qs, warp * 16, kk * 16, lane));
    m::ldsm_x4(gf[kk], m::a_addr<LDS>(dOs, warp * 16, kk * 16, lane));
  }

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kend = causal ? min(S, q0 + BR16) : S;
  const int ntiles = (kend + BKQ16 - 1) / BKQ16;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BKQ16;
    __syncthreads();  // every warp is done with the previous K and V
    m::load_tile_async<BKQ16, THREADS16, D>(Ks, kb, st.k_ss, k0, S, tid);
    m::load_tile_async<BKQ16, THREADS16, D>(Vs, vb, st.v_ss, k0, S, tid);
    m::cp_async_commit();
    if constexpr (HAS_BIAS) {
      if (tid < BKQ16) {
        Bs[tid] = k0 + tid < S ? bias[(long long)b * S + k0 + tid] : 0.f;
      }
    }
    m::cp_async_wait<0>();
    __syncthreads();
    if (causal && k0 > wrow + 15) continue;  // wholly above the warp's rows

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) { s[n][e] = 0.f; dp[n][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        m::ldsm_x4(bk, m::bt_addr<LDS>(Ks, np * 16, kk * 16, lane));
        m::ldsm_x4(bv, m::bt_addr<LDS>(Vs, np * 16, kk * 16, lane));
        m::mma(s[2 * np], qf[kk], bk[0], bk[1]);
        m::mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        m::mma(dp[2 * np], gf[kk], bv[0], bv[1]);
        m::mma(dp[2 * np + 1], gf[kk], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = wrow + g + i * 8;
        const int c = k0 + n * 8 + 2 * t + (e & 1);
        const bool visible = r < S && c < S && (!causal || c <= r);
        float sv = s[n][e] * scale_log2;
        if constexpr (HAS_BIAS) sv += Bs[c - k0];
        const float p = visible ? exp2f(sv - row_lse[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      m::a_from_c(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < KD; ++dp2) {
        uint32_t bk[4];
        m::ldsm_x4_t(bk, m::b_addr_t<LDS>(Ks, kk * 16, dp2 * 16, lane));
        m::mma(acc[2 * dp2], da, bk[0], bk[1]);
        m::mma(acc[2 * dp2 + 1], da, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + i * 8;
    if (r >= S) continue;
    bf16* row = dq + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS16)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, Strides st,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int S, int causal, float scale) {
  namespace m = bf16mma;
  constexpr int LDS = m::Tile<D>::LDS;
  constexpr int KD = D / 16;  // k-steps over the head dim
  __shared__ __align__(16) bf16 Ks[BR16 * LDS];
  __shared__ __align__(16) bf16 Vs[BR16 * LDS];
  __shared__ __align__(16) bf16 Qs[BQK16 * LDS];
  __shared__ __align__(16) bf16 dOs[BQK16 * LDS];
  __shared__ float Ls[BQK16];  // lse of the query tile, base 2
  __shared__ float Es[BQK16];  // delta of the query tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BR16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wkey = k0 + warp * 16;  // the warp's first key
  const float scale_log2 = scale * m::LOG2E;

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  const bf16* dob = dout + b * st.do_sb + h * st.do_sh;
  m::load_tile_async<BR16, THREADS16, D>(Ks, kb, st.k_ss, k0, S, tid);
  m::load_tile_async<BR16, THREADS16, D>(Vs, vb, st.v_ss, k0, S, tid);
  m::cp_async_commit();
  m::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    m::ldsm_x4(kf[kk], m::a_addr<LDS>(Ks, warp * 16, kk * 16, lane));
    m::ldsm_x4(vf[kk], m::a_addr<LDS>(Vs, warp * 16, kk * 16, lane));
  }

  float dk_acc[2 * KD][4], dv_acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk_acc[n][e] = 0.f; dv_acc[n][e] = 0.f; }
  float key_bias[2] = {0.f, 0.f};  // this lane's two keys, base 2
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = wkey + g + i * 8;
      if (key < S) key_bias[i] = bias[(long long)b * S + key];
    }
  }

  // causal: query tiles that end before the block's first key see none of it
  const int qstart = causal ? k0 / BQK16 : 0;
  const int ntiles = (S + BQK16 - 1) / BQK16;
  for (int qt = qstart; qt < ntiles; ++qt) {
    const int q0 = qt * BQK16;
    __syncthreads();  // every warp is done with the previous Q, dO, Ls, Es
    m::load_tile_async<BQK16, THREADS16, D>(Qs, qb, st.q_ss, q0, S, tid);
    m::load_tile_async<BQK16, THREADS16, D>(dOs, dob, st.do_ss, q0, S, tid);
    m::cp_async_commit();
    if (tid < BQK16) {
      const int r = q0 + tid;
      Ls[tid] =
          r < S ? __fmul_rn(lse[(long long)bh * S + r], m::LOG2E) : 0.f;
      Es[tid] = r < S ? delta[(long long)bh * S + r] : 0.f;
    }
    m::cp_async_wait<0>();
    __syncthreads();
    if (causal && q0 + BQK16 - 1 < wkey) continue;  // sees none of our keys

    float sp[4][4], dsp[4][4];  // P^T then; dP^T, then dS^T
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) { sp[n][e] = 0.f; dsp[n][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bg[4];
        m::ldsm_x4(bq, m::bt_addr<LDS>(Qs, np * 16, kk * 16, lane));
        m::ldsm_x4(bg, m::bt_addr<LDS>(dOs, np * 16, kk * 16, lane));
        m::mma(sp[2 * np], kf[kk], bq[0], bq[1]);
        m::mma(sp[2 * np + 1], kf[kk], bq[2], bq[3]);
        m::mma(dsp[2 * np], vf[kk], bg[0], bg[1]);
        m::mma(dsp[2 * np + 1], vf[kk], bg[2], bg[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = wkey + g + (e >> 1) * 8;
        const int qc = n * 8 + 2 * t + (e & 1);
        const int r = q0 + qc;  // query
        const bool visible = r < S && key < S && (!causal || key <= r);
        float sv = sp[n][e] * scale_log2;
        if constexpr (HAS_BIAS) sv += key_bias[e >> 1];
        const float p = visible ? exp2f(sv - Ls[qc]) : 0.f;
        sp[n][e] = p;
        dsp[n][e] = p * (dsp[n][e] - Es[qc]) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4], da[4];
      m::a_from_c(pa, sp[2 * kk], sp[2 * kk + 1]);
      m::a_from_c(da, dsp[2 * kk], dsp[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < KD; ++dp2) {
        uint32_t bg[4], bq[4];
        m::ldsm_x4_t(bg, m::b_addr_t<LDS>(dOs, kk * 16, dp2 * 16, lane));
        m::ldsm_x4_t(bq, m::b_addr_t<LDS>(Qs, kk * 16, dp2 * 16, lane));
        m::mma(dv_acc[2 * dp2], pa, bg[0], bg[1]);
        m::mma(dv_acc[2 * dp2 + 1], pa, bg[2], bg[3]);
        m::mma(dk_acc[2 * dp2], da, bq[0], bq[1]);
        m::mma(dk_acc[2 * dp2 + 1], da, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wkey + g + i * 8;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * H + h) * D;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, const Strides& st, void* dq, int B,
                   int H, int S, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + BR16 - 1) / BR16, B * H);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  bf16* dqp = static_cast<bf16*>(dq);
  if (bias != nullptr) {
    flash_bwd_dq_bf16_kernel<D, true><<<grid, THREADS16, 0, stream>>>(
        qp, kp, vp, bias, dop, lse, delta, st, dqp, H, S, causal, scale);
  } else {
    flash_bwd_dq_bf16_kernel<D, false><<<grid, THREADS16, 0, stream>>>(
        qp, kp, vp, bias, dop, lse, delta, st, dqp, H, S, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, const Strides& st, void* dk, void* dv,
                    int B, int H, int S, int causal, float scale,
                    cudaStream_t stream) {
  const dim3 grid((S + BR16 - 1) / BR16, B * H);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  if (bias != nullptr) {
    flash_bwd_dkv_bf16_kernel<D, true><<<grid, THREADS16, 0, stream>>>(
        qp, kp, vp, bias, dop, lse, delta, st, dkp, dvp, H, S, causal, scale);
  } else {
    flash_bwd_dkv_bf16_kernel<D, false><<<grid, THREADS16, 0, stream>>>(
        qp, kp, vp, bias, dop, lse, delta, st, dkp, dvp, H, S, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and dO in that order;
// bias: [B, S] f32 or null.
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
