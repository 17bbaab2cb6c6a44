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
// and each thread keeps a 4 x 4 register block of each accumulator and a
// 4 x 2 block of each score tile.  wgmma, TMA pipelining and bf16 are
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // head dim (the wrapper rejects others)
constexpr int BR = 64;         // rows owned by a block (queries or keys)
constexpr int BC = 32;         // rows of the streamed tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr int LD = D + 1;      // padded row: conflict-free column reads
constexpr int LDP = BC + 1;

// Load rows [r0, r0 + rows) of a strided [S, D] head slice into smem with
// float4 reads; rows past S are zero.
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
    float* row = dst + r * LD + c;
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
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    Strides st, float* __restrict__ dq, int H, int S,
                    int causal, float scale) {
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
  load_tile(Qs, qb, st.q_ss, q0, BR, S, tid);
  load_tile(dOs, dob, st.do_ss, q0, BR, S, tid);

  float row_lse[4], row_delta[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    row_delta[i] = r < S ? delta[(long long)bh * S + r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BR) : S;
  const int ntiles = (kend + BC - 1) / BC;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BC;
    __syncthreads();  // previous tile consumed (and Q, dO staged)
    load_tile(Ks, kb, st.k_ss, k0, BC, S, tid);
    load_tile(Vs, vb, st.v_ss, k0, BC, S, tid);
    __syncthreads();

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
        const float p = visible ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float ds[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    float* row = dq + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

// dK/dV pass: one block per (b*h, 64-key tile); loop over 32-query tiles,
// working on transposed [key, query] score tiles.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     Strides st, float* __restrict__ dk, float* __restrict__ dv,
                     int H, int S, int causal, float scale) {
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
  load_tile(Ks, kb, st.k_ss, k0, BR, S, tid);
  load_tile(Vs, vb, st.v_ss, k0, BR, S, tid);

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }

  // causal: query tiles that end before the block's first key see none of it
  const int qstart = causal ? k0 / BC : 0;
  const int ntiles = (S + BC - 1) / BC;
  for (int qt = qstart; qt < ntiles; ++qt) {
    const int q0 = qt * BC;
    __syncthreads();  // previous tile consumed (and K, V staged)
    load_tile(Qs, qb, st.q_ss, q0, BC, S, tid);
    load_tile(dOs, dob, st.do_ss, q0, BC, S, tid);
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
        const float p = visible ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
        Ps[(ty * 4 + i) * LDP + qc] = p;
        dSs[(ty * 4 + i) * LDP + qc] = p * (dp[i][j] - Es[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float pv[4], dsv[4], gv[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * LDP + c];
        dsv[i] = dSs[(ty * 4 + i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = dOs[c * LD + tx + 16 * j];
        qv[j] = Qs[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

constexpr size_t DQ_SMEM = sizeof(float) * (2 * BR * LD + 2 * BC * LD + BR * LDP);
constexpr size_t DKV_SMEM =
    sizeof(float) * (2 * BR * LD + 2 * BC * LD + 2 * BR * LDP + 2 * BC);

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and dO in that order.
extern "C" int flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const long long* strides,
    float* dq, int B, int H, int S, int causal, float scale, void* stream) {
  // above 48 KB a block's shared memory must be asked for explicitly
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + BR - 1) / BR, B * H);
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, make_strides(strides), dq, H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const long long* strides,
    float* dk, float* dv, int B, int H, int S, int causal, float scale,
    void* stream) {
  // above 48 KB a block's shared memory must be asked for explicitly
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + BR - 1) / BR, B * H);
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, make_strides(strides), dk, dv, H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
