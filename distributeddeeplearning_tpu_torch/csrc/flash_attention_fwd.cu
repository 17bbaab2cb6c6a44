// Causal flash-attention forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_attention.py:_kernel (launched by _flash_fwd_pallas).  Computes
//   O = softmax(Q K^T / sqrt(D) + bias + causal) V   and   lse = log-sum-exp
// of the scaled, masked scores in nats, per (batch, head, query row).
//
// Key-padding bias.  With a non-null `bias` ([B, S] f32, 0 or -1e30 per
// key, shared by the heads of a batch row) every kernel here is built with
// HAS_BIAS and adds bias[b, key] to each score before the running max, as
// the Pallas kernel adds it to its base-2 scores (has_bias).  It is an
// additive term, not a skip: a row whose keys are all masked gets the
// uniform mean of V over its visible keys, as the reference does, where a
// skip would leave l = 0.  Keys that are invisible by position (causal, or
// past S) take a fill below every biased score, so they never count.
// Without a bias (the LM and serving launches) HAS_BIAS is false and the
// code is the unbiased kernel's.
//
// Layout.  q, k and v arrive as the [B, S, H, D] views that the model's
// qkv split produces: rows of one head are D floats apart from nothing but
// their own stride, so the kernel takes (batch, seq, head) strides and
// reads the views in place -- there is no copy in the wrapper.  The last
// dimension must be contiguous.  O is written [B, S, H, D] contiguous (the
// model reshapes it to [B, S, H*D] for free); lse is [B, H, S].
//
// Head dim.  Every kernel here is a template on the head dim D, built for
// D in {16, 32, 64} (the reference's defaults: `ddlt serve`'s d 64 over 4
// heads, the LM trainer's d 256 over 8, the serve and train benchmarks'
// d 768 over 12); the entry points take D and refuse any other value with
// cudaErrorInvalidValue, as the wrapper refuses it first.  At D = 64 the
// arithmetic is the one the kernels had before they took D, operation for
// operation.
//
// Design.  One thread block per (b*h, 64-row query tile); a loop over
// 32-key tiles inside the block takes the place of the TPU grid's
// sequential k axis.  Q, K and V tiles are staged in shared memory, the
// running (m, l, acc) live in registers (each of the 256 threads owns 4
// query rows x D/16 output columns -- columns tx + 16 j -- and 4 x 2
// scores of each tile).  With
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

#include "bf16_mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per inner tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr float NEG_BIG = -1e30f;

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int causal, float scale) {
  constexpr int DJ = D / 16;  // output columns a thread owns
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

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
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

    // this lane's two keys' bias, in nats: the reference adds it to base-2
    // scores, so a -1e30 there is -1e30 * ln 2 here
    float kb_nat[2] = {0.f, 0.f};
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c < S) {
          kb_nat[j] = __fmul_rn(bias[(long long)b * S + c], bf16mma::LN2);
        }
      }
    }

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
        float sv = s[i][j] * scale;
        if constexpr (HAS_BIAS) sv += kb_nat[j];
        // NEG_BIG lies below every biased score (-1e30 * ln 2 at least)
        s[i][j] = visible ? sv : NEG_BIG;
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
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
      Ps[ty * 4 + i][tx] = p0;
      Ps[ty * 4 + i][tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[ty * 4 + i][c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);  // fully-masked rows stay finite
    float* orow = o + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] / ll;
    if (tx == 0) lse[((long long)b * H + h) * S + r] = m[i] + logf(ll);
  }
}

template <int D>
int launch_fwd_f32(const float* q, const float* k, const float* v,
                   const float* bias,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, float* o,
                   float* lse, int B, int H, int S, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  if (bias != nullptr) {
    flash_fwd_kernel<D, true><<<grid, THREADS, 0, stream>>>(
        q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        o, lse, H, S, causal, scale);
  } else {
    flash_fwd_kernel<D, false><<<grid, THREADS, 0, stream>>>(
        q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        o, lse, H, S, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float* o, float* lse, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_fwd_f32<16>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                causal, scale, st);
    case 32:
      return launch_fwd_f32<32>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                causal, scale, st);
    case 64:
      return launch_fwd_f32<64>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: the same function for bf16 q, k, v (the
// Pallas kernel's native bf16 path), with its rounding points: S = Q K^T and
// P V accumulate in f32, P is rounded to bf16 only as the operand of P V,
// the row sums l take the f32 P, O = acc / max(l, 1e-30) is rounded to bf16
// once at the end, lse stays f32 in nats.  The online softmax runs in base 2
// (exp2 of scores pre-scaled by log2 e), as the Pallas kernel does.
//
// Design.  One block of 4 warps per (b*h, 64-row query tile); each warp owns
// 16 query rows and keeps its Q fragments (D/16 k-steps), its 16 x D f32
// output tile (D/8 n-tiles of 8 columns) and its rows' (m, l) in registers.  A loop over 64-key tiles stages K and V in
// shared memory with cp.async (V's copy overlaps the S product); S = Q K^T
// and O += P V are mma.sync m16n8k16 bf16 products, B operands read with
// ldmatrix (.trans for V); at D = 16, Q K^T is a single k-step and P V two
// n-tiles.  S's accumulator is rounded in registers into P's A operand, so
// P never touches shared memory.  Row max and row sum reduce over the four
// lanes of a quad.  With causal masking the loop stops at the block's
// diagonal tile, a warp skips tiles wholly above its own rows, and the
// tiles it visits are masked elementwise with -1e30.  Keys and rows past S
// are zero-filled by the copy (src-size 0) and masked.  With HAS_BIAS each
// K tile's 64 bias values are staged in shared memory beside it and added
// to the base-2 scores as they are (the reference's own units); keys
// invisible by position then take 2 * -1e30, the sum the reference's
// additive causal term gives, below every biased score.
//
// Bound on the H100.  At the training shape (B=8, H=12, S=2048, D=64,
// causal) 4 D flops per visible pair at the 989 TFLOP/s dense bf16 peak
// take ~0.05 ms against ~0.04 ms for the bytes: bound by operations.
// mma.sync reaches part of that peak; wgmma, TMA and a deeper pipeline are
// later work.

namespace {

using bf16mma::bf16;

constexpr int BQ16 = 64;        // query rows a block (16 a warp)
constexpr int BK16 = 64;        // keys a tile
constexpr int THREADS16 = 128;  // 4 warps

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS16)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int H, int S, int causal, float scale_log2) {
  namespace m = bf16mma;
  constexpr int LDS = m::Tile<D>::LDS;
  constexpr int KD = D / 16;  // k-steps of Q K^T, n-tile pairs of P V
  constexpr float FILL = HAS_BIAS ? 2.f * NEG_BIG : NEG_BIG;
  __shared__ __align__(16) bf16 Qs[BQ16 * LDS];
  __shared__ __align__(16) bf16 Ks[BK16 * LDS];
  __shared__ __align__(16) bf16 Vs[BK16 * LDS];
  __shared__ float Bs[HAS_BIAS ? BK16 : 1];  // the K tile's key bias

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ16;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + warp * 16;  // the warp's first query row

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  m::load_tile_async<BQ16, THREADS16, D>(Qs, qb, q_ss, q0, S, tid);
  m::cp_async_commit();
  m::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    m::ldsm_x4(qf[kk], m::a_addr<LDS>(Qs, warp * 16, kk * 16, lane));

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};  // this lane's share of the row sums

  const int kend = causal ? min(S, q0 + BQ16) : S;
  const int ntiles = (kend + BK16 - 1) / BK16;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK16;
    __syncthreads();  // every warp is done with the previous K and V
    m::load_tile_async<BK16, THREADS16, D>(Ks, kb, k_ss, k0, S, tid);
    m::cp_async_commit();
    m::load_tile_async<BK16, THREADS16, D>(Vs, vb, v_ss, k0, S, tid);
    m::cp_async_commit();
    if constexpr (HAS_BIAS) {
      if (tid < BK16) {
        Bs[tid] = k0 + tid < S ? bias[(long long)b * S + k0 + tid] : 0.f;
      }
    }
    m::cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    const bool active = !causal || k0 <= wrow + 15;
    float s[8][4];
    if (active) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          m::ldsm_x4(bk, m::bt_addr<LDS>(Ks, np * 16, kk * 16, lane));
          m::mma(s[2 * np], qf[kk], bk[0], bk[1]);
          m::mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wrow + g + (e >> 1) * 8;
          const int c = k0 + n * 8 + 2 * t + (e & 1);
          const bool visible = c < S && (!causal || c <= r);
          float sv = s[n][e] * scale_log2;
          if constexpr (HAS_BIAS) sv += Bs[c - k0];
          s[n][e] = visible ? sv : FILL;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(mrow[i], mx[i]);
        corr[i] = exp2f(mrow[i] - m_new);  // 0 on the warp's first tile
        mrow[i] = m_new;
        lrow[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mrow[e >> 1]);
          lrow[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    m::cp_async_wait<0>();
    __syncthreads();  // V has landed
    if (active) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        m::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t bv[4];
          m::ldsm_x4_t(bv, m::b_addr_t<LDS>(Vs, kk * 16, dp * 16, lane));
          m::mma(acc[2 * dp], pa, bv[0], bv[1]);
          m::mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    const int r = wrow + g + i * 8;
    if (r >= S) continue;
    const float ll = fmaxf(lrow[i], 1e-30f);  // fully-masked rows stay finite
    bf16* orow = o + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] / ll, acc[n][2 * i + 1] / ll);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * S + r] =
          (mrow[i] + log2f(ll)) * bf16mma::LN2;
    }
  }
}

template <int D, bool HAS_BIAS>
void launch_fwd_bf16_as(dim3 grid, const void* q, const void* k,
                        const void* v, const float* bias,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        void* o, float* lse, int H, int S, int causal,
                        float scale, cudaStream_t stream) {
  flash_fwd_bf16_kernel<D, HAS_BIAS><<<grid, THREADS16, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, static_cast<bf16*>(o), lse, H, S, causal,
      scale * bf16mma::LOG2E);
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const float* bias,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh, void* o,
                    float* lse, int B, int H, int S, int causal, float scale,
                    cudaStream_t stream) {
  const dim3 grid((S + BQ16 - 1) / BQ16, B * H);
  if (bias != nullptr) {
    launch_fwd_bf16_as<D, true>(grid, q, k, v, bias, q_sb, q_ss, q_sh, k_sb,
                                k_ss, k_sh, v_sb, v_ss, v_sh, o, lse, H, S,
                                causal, scale, stream);
  } else {
    launch_fwd_bf16_as<D, false>(grid, q, k, v, bias, q_sb, q_ss, q_sh, k_sb,
                                 k_ss, k_sh, v_sb, v_ss, v_sh, o, lse, H, S,
                                 causal, scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    void* o, float* lse, int B, int H, int S, int D, int causal, float scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_fwd_bf16<16>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                 causal, scale, st);
    case 32:
      return launch_fwd_bf16<32>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                 causal, scale, st);
    case 64:
      return launch_fwd_bf16<64>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, o, lse, B, H, S,
                                 causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
