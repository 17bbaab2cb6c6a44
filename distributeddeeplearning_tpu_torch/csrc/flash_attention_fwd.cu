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
#include <string.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

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
// bf16 forward on Hopper's tensor cores: the same function for bf16 q, k, v
// (the Pallas kernel's native bf16 path), with its rounding points: S = Q K^T
// and P V accumulate in f32, P is rounded to bf16 only as the operand of
// P V, the row sums l take the f32 P, O = acc / max(l, 1e-30) is rounded to
// bf16 once at the end, lse stays f32 in nats.  The online softmax runs in
// base 2 on scores scaled by scale * log2 e, as the Pallas kernel does.
// Without a bias the row max is taken on the unscaled scores (rounding is
// monotone, so scaling it gives the max of the scaled scores) and each
// P = exp2(s * c - m) is one fused multiply-add into the SFU's exp2; with a
// bias the scores are scaled and biased first.
//
// Design (warp-specialised, built from csrc/hopper.cuh).  One block per
// (b*h, tile of BQ = 64 * NC query rows).  Warpgroup 0 is the producer: it
// gives back registers (setmaxnreg.dec) and one thread issues TMA loads --
// the block's Q rows once, then each 128-key tile of K and V (and, with
// HAS_BIAS, the tile's f32 bias values) into a ring of STAGES = 2 stages,
// each guarded by a full and an empty mbarrier.  Warpgroups 1..NC are
// consumers (setmaxnreg.inc), each owning 64 query rows.  Per tile a
// consumer waits on the stage's full barrier, computes S = Q K^T as wgmma
// m64n128k16 from shared memory (Q and K K-major), masks and exponentiates
// S in registers, rounds it pairwise into P's register A operand, runs
// O += P V as wgmma m64nDk16 with V read MN-major through the transpose
// bit, waits for the product to retire and releases the stage (one arrival
// per warpgroup on the empty barrier).  (m, l, O) stay in registers; O is
// written from them at the end.  The tensor maps span exactly the
// [B, S, H, D] views (dims D, H, S, B, with the views' own strides, read
// in place), and TMA writes zeros for rows past S, so nothing past row S
// is ever read.  Tiles land in the swizzled layout wgmma reads (128-, 64-
// or 32-byte swizzle for D = 64, 32, 16).
//
// Masks.  Only a tile that crosses the causal diagonal of the warpgroup's
// rows or runs past S is masked elementwise (a finite fill, never -inf).
// With causal masking the producer stops at the block's last row and a
// warpgroup only releases the tiles wholly above its rows.  With HAS_BIAS
// the bias is added to the base-2 scores as it is (the reference's own
// units) and keys invisible by position take 2 * -1e30, below every biased
// score, so a fully masked row still averages the keys it sees by
// position.  Tiles run in ascending key order, so a row's first tile always
// holds key 0, which it sees.
//
// Choices, each timed against the others in one call on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_flash.py; the readings are in PERF.md): at
// the training shape (B=8, H=12, S=2048, D=64, causal) 128-key tiles took
// 0.150-0.157 ms against 0.171 for 64-key tiles; a third ring stage gained
// nothing (0.157); the folded scale gained 5-10% (0.166 without);
// overlapping a warpgroup's softmax with its own P V, with or without
// ping-pong between two warpgroups, was slower (0.197-0.205 against
// 0.186-0.189 for this serial order at 128-row blocks), and so was a fixed
// rotation of the three warpgroups' products on named barriers (0.173-
// 0.180 against 0.149-0.159); a persistent loop over tiles with a double-
// buffered Q gained nothing there (0.149-0.150) and lost 15% on serving
// prefill.  Block rows: 192 (NC = 3, every K/V tile shared by three
// warpgroups) took 0.156 against 0.186 for 128 and 0.310 for 64, but
// 0.037 against 0.027-0.029 for 128 on
// BERT's B=8 S=512, where 288 blocks make 2.2 waves of 132 SMs; so the
// launcher takes 192 rows when the grid gives every SM four blocks, 128
// when it gives every SM one, else 64-row blocks (NC = 1, two an SM):
// short sequences with few heads (serving prefill, BERT at seq 128, the
// default geometries) spread over more SMs (fwd_bf16_block_rows).  Query
// tiles are the grid's slow dimension, issued last tile first, so the
// longest causal blocks start first.
//
// Bound on the H100.  At the training shape 4 D flops per visible pair at
// the 989 TFLOP/s dense bf16 peak take ~0.05 ms against ~0.04 ms for the
// bytes: bound by operations.  At D = 64 the SFU's exp2 of a score costs
// about as long as the tensor cores' products for it, and a warpgroup's
// softmax and products alternate; the other warpgroups of the block run
// theirs in between.
//
// Registers.  ptxas reports each instance at its launch bound (128 a
// thread with 64-row blocks, two an SM, and with 192-row blocks, 512
// threads; 168 with 128-row blocks); the producer runs on 24 after
// setmaxnreg.dec, the consumers on 232, 240 or 160 after .inc.  The bias
// instances at D = 32 and 64 with 64- and 192-row blocks spill 8-40 bytes:
// values computed before the role split, stored once and reloaded in the
// producer's 24 registers (`-Xptxas -v`; PERF.md).
//
// Host side.  The launcher encodes three (with the bias four) TMA tensor
// maps a call (cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point, so no -lcuda; ~1 us each on the host) and passes them as
// __grid_constant__ parameters.  Each kernel instance raises its dynamic
// shared-memory limit once per device and checks that its launch register
// count covers the rebalanced counts (else it refuses with
// cudaErrorInvalidConfiguration rather than wait in setmaxnreg.inc).

namespace {

using bf16mma::bf16;

constexpr int WG = 128;     // threads of a warpgroup
constexpr int QROWS = 64;   // query rows of a consumer warpgroup
constexpr int BKW = 128;    // keys a K/V tile
constexpr int STAGES = 2;   // depth of the K/V ring
// a stage's bias window: BKW values from a 16-byte aligned start, so up
// to 3 floats before the tile's first key (a TMA box must start on 16
// bytes in its innermost dimension)
constexpr int BIAS_BOX = BKW + 4;
constexpr int BIAS_STRIDE = (BIAS_BOX * 4 + 127) / 128 * 32;  // floats

template <int D, bool HAS_BIAS, int NC>
struct FwdLayout {
  static constexpr int ROW = D * 2;            // bytes of a head row
  static constexpr int Q_TILE = QROWS * ROW;   // bytes of a warpgroup's Q
  static constexpr int KV_TILE = BKW * ROW;    // bytes of a K or V tile
  static constexpr int BIAS_TILE = HAS_BIAS ? BIAS_STRIDE * 4 : 0;
  static constexpr int K_OFF = NC * Q_TILE;    // every tile on 1024 bytes
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BIAS_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = BIAS_OFF + STAGES * BIAS_TILE;
  // + slack to align the dynamic shared memory's start to 1024 bytes
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static constexpr int THREADS = WG * (NC + 1);
  // per-thread registers after rebalancing; the launch count must cover
  // them: 128 (NC = 1, two blocks an SM), 168 (NC = 2) or 128 (NC = 3)
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : NC == 2 ? 240 : 160;
  static constexpr int POOL = WG * (PRODUCER_REGS + NC * CONSUMER_REGS);
};

using hopper::exp2_ftz;

// scale, bias and mask one 64 x BKW score tile in registers
// (EDGE: the tile crosses the causal diagonal or S) and take its row
// maxima into mx
template <bool HAS_BIAS, bool EDGE>
__device__ __forceinline__ void scale_mask(float (&sc)[BKW / 2],
                                           float (&mx)[2],
                                           const float* bias_tile,
                                           float scale, int k0, int row,
                                           int t, int S, int causal) {
  constexpr float FILL = HAS_BIAS ? 2.f * NEG_BIG : NEG_BIG;
#pragma unroll
  for (int j = 0; j < BKW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);  // key within the tile
      float sv = sc[4 * j + e] * scale;
      if constexpr (HAS_BIAS) sv += bias_tile[c];
      if constexpr (EDGE) {
        const int r = row + (e >> 1) * 8;
        if (k0 + c >= S || (causal && k0 + c > r)) sv = FILL;
      }
      sc[4 * j + e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  }
}

// The online softmax of one scored tile: new row maxima (corr rescales
// what came before, 0 on the first tile), P = exp2(S - m) in f32 summed
// into this lane's share of l, and P rounded pairwise into the A operand
// of k-step j / 2 (the order in hopper.cuh).  Without a bias the scores
// stay unscaled until the fused multiply-add of each exponent.
template <bool HAS_BIAS>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BKW / 2], float (&mrow)[2], float (&lrow)[2],
    float (&corr)[2], uint32_t (&pa)[BKW / 16][4], const float* bias_tile,
    float scale_log2, int k0, int r0, int row, int t, int S, int causal) {
  constexpr bool fold = !HAS_BIAS;
  const float mul = fold ? 1.f : scale_log2;  // applied to S before the max
  float mx[2] = {NEG_BIG, NEG_BIG};
  if (k0 + BKW > S || (causal && k0 + BKW - 1 > r0)) {
    scale_mask<HAS_BIAS, true>(sc, mx, bias_tile, mul, k0, row, t, S, causal);
  } else if constexpr (fold) {
#pragma unroll
    for (int i = 0; i < BKW / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
  } else {
    scale_mask<HAS_BIAS, false>(sc, mx, bias_tile, mul, k0, row, t, S,
                                causal);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if constexpr (fold) mx[i] *= scale_log2;
    const float m_new = fmaxf(mrow[i], mx[i]);
    corr[i] = exp2_ftz(mrow[i] - m_new);
    mrow[i] = m_new;
    lrow[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BKW / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = mrow[e >> 1];
      p[e] = exp2_ftz(fold ? fmaf(sc[4 * j + e], scale_log2, -m)
                           : sc[4 * j + e] - m);
      lrow[e >> 1] += p[e];
    }
    hopper::pack_a(pa, j, p);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i >> 1) & 1];
}

template <int D, bool HAS_BIAS, int NC>
__global__ void __launch_bounds__(WG * (NC + 1), NC == 1 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_bias,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int S, int causal, float scale_log2) {
  namespace hp = hopper;
  using L = FwdLayout<D, HAS_BIAS, NC>;
  constexpr int BQ = QROWS * NC;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* Bs = reinterpret_cast<float*>(smem + L::BIAS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last query tile first
  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BKW - 1) / BKW;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], NC);
    }
    hp::mbar_init(qbar, 1);
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
      if constexpr (HAS_BIAS) hp::prefetch_tensormap(&tm_bias);
      // the warpgroups' Q boxes that hold a row below S
      const int nq = min(NC, (S - q0 + QROWS - 1) / QROWS);
      hp::mbar_arrive_expect_tx(qbar, nq * L::Q_TILE);
      for (int i = 0; i < nq; ++i) {
        hp::tma_load_4d(Qs + i * QROWS * D, &tm_q, qbar, 0, h, q0 + i * QROWS,
                        b);
      }
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % STAGES;
        // the stage's previous tile released by every consumer
        if (kt >= STAGES) hp::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(
            &full[s], 2 * L::KV_TILE + (HAS_BIAS ? BIAS_BOX * 4 : 0));
        hp::tma_load_4d(Ks + s * BKW * D, &tm_k, &full[s], 0, h, kt * BKW, b);
        hp::tma_load_4d(Vs + s * BKW * D, &tm_v, &full[s], 0, h, kt * BKW, b);
        if constexpr (HAS_BIAS) {
          hp::tma_load_1d(Bs + s * BIAS_STRIDE, &tm_bias, &full[s],
                          (b * S + kt * BKW) & ~3);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    hp::reg_alloc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * WG;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + c * QROWS;       // the warpgroup's first row
    const int row = r0 + warp * 16 + g;  // this thread's rows: row, row + 8
    const uint32_t q_addr = hp::smem_u32(Qs + c * QROWS * D);
    const uint32_t k_addr = hp::smem_u32(Ks);
    const uint32_t v_addr = hp::smem_u32(Vs);
    // the tiles this warpgroup computes come first: with causal masking,
    // those that start at or before its last row; it releases the rest
    const int nact = r0 >= S ? 0
                     : causal ? min(ntiles, (r0 + QROWS - 1) / BKW + 1)
                              : ntiles;
    // this tile's bias, from its stage's 16-byte aligned window
    auto bias_at = [&](int s, int k0) {
      return Bs + s * BIAS_STRIDE + ((b * S + k0) & 3);
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY};
    float lrow[2] = {0.f, 0.f};  // this lane's share of the row sums
    float sc[BKW / 2];
    float corr[2];
    uint32_t pa[BKW / 16][4];
    if (nact > 0) hp::mbar_wait(qbar, 0);

    for (int kt = 0; kt < nact; ++kt) {
      const int s = kt % STAGES;
      hp::mbar_wait(&full[s], (kt / STAGES) & 1);
      hp::fence();
      hp::ss_k_major<L::ROW, BKW>(sc, q_addr, k_addr + s * L::KV_TILE);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(sc);
      softmax_tile<HAS_BIAS>(sc, mrow, lrow, corr, pa, bias_at(s, kt * BKW),
                             scale_log2, kt * BKW, r0, row, t, S, causal);
      rescale(acc, corr);
      hp::fence();
      hp::rs_mn_major<L::ROW, BKW>(acc, pa, v_addr + s * L::KV_TILE);
      hp::commit();
      hp::wait<0>();
      hp::fence_operand(acc);
      hp::fence_operand(pa);
      if (tid == 0) hp::mbar_arrive(&empty[s]);  // its products retired
    }
    for (int kt = nact; kt < ntiles; ++kt) {  // tiles wholly above its rows
      const int s = kt % STAGES;
      hp::mbar_wait(&full[s], (kt / STAGES) & 1);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
      const int r = row + i * 8;
      if (r >= S) continue;
      const float ll = fmaxf(lrow[i], 1e-30f);  // fully-masked rows stay finite
      bf16* orow = o + (((long long)b * S + r) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / ll,
                                  acc[4 * j + 2 * i + 1] / ll);
      }
      if (t == 0) {
        lse[((long long)b * H + h) * S + r] =
            (mrow[i] + log2f(ll)) * bf16mma::LN2;
      }
    }
  }
}

// Query rows a block: 192, 128 or 64 (see the note above)
int fwd_bf16_block_rows(int B, int H, int S) {
  return hopper::block_rows(B, H, S, 192);
}

template <int D, bool HAS_BIAS, int NC>
int launch_fwd_bf16_as(const CUtensorMap (&maps)[4], void* o, float* lse,
                       int B, int H, int S, int causal, float scale,
                       cudaStream_t stream) {
  using L = FwdLayout<D, HAS_BIAS, NC>;
  const auto kernel = flash_fwd_bf16_kernel<D, HAS_BIAS, NC>;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = hopper::configure_once(kernel, L::BYTES, L::THREADS,
                                                 L::POOL, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + QROWS * NC - 1) / (QROWS * NC));
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(o), lse, H, S,
      causal, scale * bf16mma::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const float* bias,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh, void* o,
                    float* lse, int B, int H, int S, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap maps[4];
  memset(&maps[3], 0, sizeof(CUtensorMap));
  using hopper::encode_rows;
  bool ok = encode_rows<D>(&maps[0], q, q_sb, q_ss, q_sh, B, H, S, QROWS) &&
            encode_rows<D>(&maps[1], k, k_sb, k_ss, k_sh, B, H, S, BKW) &&
            encode_rows<D>(&maps[2], v, v_sb, v_ss, v_sh, B, H, S, BKW);
  if (bias != nullptr) {
    // the [B, S] bias as one run of B*S floats: a tile of row b starts at
    // b*S + k0, its window 0-3 floats before; values past S belong to
    // masked keys, past B*S read as 0
    ok = ok && hopper::encode_window(&maps[3], bias, (long long)B * S, BIAS_BOX);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = fwd_bf16_block_rows(B, H, S);
  const bool wide = rows == 128;
  if (rows == 192) {
    return bias != nullptr ? launch_fwd_bf16_as<D, true, 3>(maps, o, lse, B, H, S, causal, scale, stream)
                           : launch_fwd_bf16_as<D, false, 3>(maps, o, lse, B, H, S, causal, scale, stream);
  }
  if (bias != nullptr) {
    return wide ? launch_fwd_bf16_as<D, true, 2>(maps, o, lse, B, H, S,
                                                 causal, scale, stream)
                : launch_fwd_bf16_as<D, true, 1>(maps, o, lse, B, H, S,
                                                 causal, scale, stream);
  }
  return wide ? launch_fwd_bf16_as<D, false, 2>(maps, o, lse, B, H, S, causal,
                                                scale, stream)
              : launch_fwd_bf16_as<D, false, 1>(maps, o, lse, B, H, S, causal,
                                                scale, stream);
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

// The query rows a block of the bf16 forward takes at (B, H, S) on the
// current device: 192, 128 or 64 (see fwd_bf16_block_rows).
extern "C" int flash_attention_fwd_bf16_block_rows(int B, int H, int S) {
  return fwd_bf16_block_rows(B, H, S);
}

// Dynamic shared memory, in bytes, of the bf16 forward's instance for head
// dim D, with or without the bias, at `rows` query rows a block; -1 if
// there is no such instance.
extern "C" int flash_attention_fwd_bf16_smem_bytes(int D, int has_bias,
                                                   int rows) {
  const int nc = rows / QROWS;
  if (rows % QROWS != 0 || nc < 1 || nc > 3 || (D != 16 && D != 32 && D != 64)) {
    return -1;
  }
  const int sizes[3][3][2] = {
      {{FwdLayout<16, false, 1>::BYTES, FwdLayout<16, true, 1>::BYTES},
       {FwdLayout<16, false, 2>::BYTES, FwdLayout<16, true, 2>::BYTES},
       {FwdLayout<16, false, 3>::BYTES, FwdLayout<16, true, 3>::BYTES}},
      {{FwdLayout<32, false, 1>::BYTES, FwdLayout<32, true, 1>::BYTES},
       {FwdLayout<32, false, 2>::BYTES, FwdLayout<32, true, 2>::BYTES},
       {FwdLayout<32, false, 3>::BYTES, FwdLayout<32, true, 3>::BYTES}},
      {{FwdLayout<64, false, 1>::BYTES, FwdLayout<64, true, 1>::BYTES},
       {FwdLayout<64, false, 2>::BYTES, FwdLayout<64, true, 2>::BYTES},
       {FwdLayout<64, false, 3>::BYTES, FwdLayout<64, true, 3>::BYTES}}};
  return sizes[D == 16 ? 0 : D == 32 ? 1 : 2][nc - 1][has_bias ? 1 : 0];
}
