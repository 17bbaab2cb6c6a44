// Causal flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_attention.py:_kernel (launched by _flash_fwd_pallas).  Computes
//   O = softmax(Q K^T / sqrt(D) + causal) V     and     lse = log-sum-exp
// of the scaled, masked scores in nats, per (batch, head, query row).
//
// Layout.  q, k and v arrive as the [B, S, H, D] views that the model's
// qkv split produces: rows of one head are D floats apart from nothing but
// their own stride, so the kernel takes (batch, seq, head) strides and
// reads the views in place -- there is no copy in the wrapper.  The last
// dimension must be contiguous.  O is written [B, S, H, D] contiguous (the
// model reshapes it to [B, S, H*D] for free); lse is [B, H, S].
//
// Design.  One thread block per (b*h, 64-row query tile); a loop over
// 32-key tiles inside the block takes the place of the TPU grid's
// sequential k axis.  Q, K and V tiles are staged in shared memory, the
// running (m, l, acc) live in registers (each of the 256 threads owns 4
// query rows x 4 output columns, and 4 x 2 scores of each tile).  With
// causal masking the loop stops at the tile holding the block's last
// query row (the whole-tile skip above the diagonal); the tiles it does
// visit are masked elementwise with the finite -1e30 fill, never -inf, as
// the reference does.  Rows and keys past S (the ragged last tile) are
// zero-filled on load and masked, so any S works.  The online softmax runs
// in natural base; only the nats interface of lse matters.
//
// Bound on the H100.  At the serve shapes (B=1, H=12, D=64, S <= 576)
// the kernel moves ~3.5 MB and does ~0.9 GFLOP: it is bound by operations.
// It uses plain FMA on CUDA cores (67 TFLOP/s peak in f32), not TF32 mma,
// because TF32 would break the float32 parity the port is held to.  The
// tiling re-reads each K/V tile once per query tile from shared memory
// rather than global memory; making it fast (wgmma in bf16, deeper
// pipelining) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // head dim (the wrapper rejects others)
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per inner tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr float NEG_BIG = -1e30f;

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int causal, float scale) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ __align__(16) float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // lane in the row group

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int f = tid; f < BQ * (D / 4); f += THREADS) {
    const int r = f / (D / 4);
    const int c = (f % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = *reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * q_ss + c);
    }
    Qs[r][c] = x.x; Qs[r][c + 1] = x.y; Qs[r][c + 2] = x.z; Qs[r][c + 3] = x.w;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int f = tid; f < BK * (D / 4); f += THREADS) {
      const int r = f / (D / 4);
      const int c = (f % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < S) {
        kx = *reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * k_ss + c);
        vx = *reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * v_ss + c);
      }
      Ks[r][c] = kx.x; Ks[r][c + 1] = kx.y; Ks[r][c + 2] = kx.z; Ks[r][c + 3] = kx.w;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[ty * 4 + i][d];
      const float k0v = Ks[tx][d];
      const float k1v = Ks[tx + 16][d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool visible = c < S && (!causal || c <= r);
        s[i][j] = visible ? s[i][j] * scale : NEG_BIG;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);  // 0 on the first tile
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
      m[i] = m_new;
      Ps[ty * 4 + i][tx] = p0;
      Ps[ty * 4 + i][tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[ty * 4 + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);  // fully-masked rows stay finite
    float* orow = o + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = acc[i][j] / ll;
    if (tx == 0) lse[((long long)b * H + h) * S + r] = m[i] + logf(ll);
  }
}

}  // namespace

extern "C" int flash_attention_fwd_f32(
    const float* q, const float* k, const float* v,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float* o, float* lse, int B, int H, int S, int causal, float scale,
    void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o, lse,
      H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
