// Flash-attention forward for Hopper (sm_90a), in float32 and bfloat16
// (below), both on the tensor cores.
//
// Replaces the Pallas TPU kernel distributeddeeplearning_tpu/ops/
// flash_attention.py:_kernel (launched by _flash_fwd_pallas).  Computes
//   O = softmax(Q K^T * scale + bias + causal) V   and   lse = log-sum-exp
// of the scaled, masked scores in nats, per (batch, head, query row), with
// scale = 1/sqrt(D) from the caller.
//
// Key-padding bias.  With a non-null `bias` ([B, S] f32, 0 or -1e30 per
// key, shared by the heads of a batch row) every kernel here is built with
// HAS_BIAS and adds the bias to each score before the running max, as the
// Pallas kernel adds it to its base-2 scores (has_bias).  It is an
// additive term, not a skip: a row whose keys are all masked gets the
// uniform mean of V over its visible keys, as the reference does, where a
// skip would leave l = 0.  Keys that are invisible by position (causal, or
// past S) take a fill below every biased score, so they never count.
// Without a bias (the LM and serving launches) HAS_BIAS is false and the
// code is the unbiased kernel's.
//
// Layout.  q, k and v arrive as the [B, S, H, D] views that the model's
// qkv split produces: rows of one head are D values apart from nothing but
// their own stride, so the kernels take (batch, seq, head) strides and read
// the views in place -- there is no copy in the wrapper.  The last
// dimension must be contiguous.  O is written [B, S, H, D] contiguous (the
// model reshapes it to [B, S, H*D] for free); lse is [B, H, S].
//
// ---------------------------------------------------------------------------
// f32 forward: split TF32 ("3xTF32") on mma.sync, from csrc/tf32x3.cuh,
// the building blocks of the f32 backward's dQ pass, whose shape it has.
//
// Bound on the H100.  At the LM training shape (B=8, H=12, S=2048, D=64,
// causal) the kernel reads ~150 MB and writes ~50 MB but does 4 D flops a
// visible (query, key) pair, 5.2e10 flops: bound by operations.  On the
// CUDA cores (67 TFLOP/s of f32 FMA) that is 0.77 ms; a single TF32 product
// on the tensor cores keeps 11 significant bits, far from the f32 parity
// the port is held to.  So every product runs as three TF32 products on
// split operands (tf32x3.cuh): f32 accuracy at a third of the dense TF32
// rate, 165 TFLOP/s, a 0.31 ms bound.  On an NVIDIA H100 80GB HBM3 at
// 700 W the kernel takes ~1.03 ms there against the scalar kernel's ~2.24
// and SDPA's f32 ~1.69 (scripts/time_flash.py --only f32_k1; PERF.md).
//
// Design.  One block of NW warps owns 16 NW query rows of one (b, h); each
// warp owns 16 rows and keeps (m, l, O) in registers, O as m16n8k8 C
// fragments.  Query tiles are the grid's slow dimension, issued last tile
// first, so the longest causal blocks start first.
// - Q, the one owned operand, is loop-invariant: the block copies its rows
//   once (into the lo tiles, before any K/V tile is split there) and each
//   warp loads its 16 rows as A fragments through ldmatrix and splits them
//   into TF32 parts once, kept in registers (D of them a thread).
// - K and V (and, with HAS_BIAS, the tile's key bias) stream through a
//   two-stage cp.async ring of BN = 64-row tiles, rows of D + 4 floats.
//   After the first barrier of a tile it is visible and every warp is done
//   with the previous one, whose stage then takes the next tile while this
//   one is computed; the block splits the K and V tiles into TF32 parts
//   once, in place (a stage keeps the hi parts, the lo parts go to one lo
//   tile each), and after the second barrier every warp reads the parts.
//   At D = 64 that is 105 kB of shared memory, where separate hi tiles and
//   Q's parts in shared memory took 210 kB; a thread then holds 233-235
//   registers.
// - S = Q K^T is three TF32 products a k-step of 8 (mma3), B fragments
//   from the split tiles through ldmatrix; S stays in C fragments: a
//   thread holds rows g and g + 8, keys 2t and 2t + 1 of each 8-key tile.
// - The online softmax runs on the fragments: the row max over the
//   thread's values, then over the quad (__shfl_xor 1 and 2); P = exp(S -
//   m) in f32, its row sums l from that f32 P (a lane's share, summed over
//   the quad at the end); O rescaled by exp(m_old - m).  Without a bias
//   the max is taken on the unscaled scores (rounding is monotone) and each
//   exponent is one fused multiply-add into the SFU's exp2, in base 2;
//   with one, the scores are scaled and biased in nats first (bias * ln 2
//   by __fmul_rn, never fused, so that a fully masked row's lse is the
//   plain version's bit for bit).  Only a tile that crosses the warp's
//   causal diagonal or S is masked elementwise, with the finite -1e30,
//   never -inf.
// - O += P V (accumulate): P feeds the product from its C fragments --
//   columns 2t and 2t + 1 stand for k = t and t + 4, and the B fragment
//   takes V's rows 2t and 2t + 1 to match.  Each tile's products are
//   summed in a fresh accumulator and added to O in f32: the tensor cores
//   round their f32 sums toward zero, a bias that would grow with the
//   number of tiles in one chain of products.
// - A warp skips the tiles wholly above its rows' diagonal but keeps the
//   ring in step; the block's stream stops at its last row's tile.
// - O = acc / max(l, 1e-30) (fully masked rows stay finite) and lse =
//   m + log(l) are written at the end.
// Block sizes: the launcher picks 128 or 64 query rows a block by the grid
// against the SM count (fwd_f32_block_rows, exported for the tests).
//
// Choices, each timed against the others in one call on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_flash.py --only f32_k1; PERF.md): at
// the training shape Q's parts and separate hi tiles in shared memory took
// 1.10 ms against 1.03 for this layout, 64-row blocks (two an SM) 1.07
// against 1.03 for 128 (one); 32-row blocks were slower wherever the grid
// is short (serving prefill 0.042 against 0.034 ms, D 16 0.019 against
// 0.016, D 32 0.010 against 0.009) and equal at D 8.  Left out one at a
// time in copies of the kernel, the P V products cost 0.29 ms there, the
// Q K^T products 0.21 and the split of the K/V tiles 0.16.
//
// Head dim.  Built for D in {8, 16, 32, 64} (the reference's defaults:
// `bench.py --small`'s d 32 over 4 heads, `ddlt serve`'s d 64 over 4, the
// LM trainer's d 256 over 8, the serve and train benchmarks' d 768 over
// 12): at D = 8, Q K^T is one k-step and P V one n-tile, and a row of
// D + 4 = 12 floats keeps ldmatrix and cp.async on 16 bytes.  The entry
// point refuses any other D with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float NEG_BIG = -1e30f;
constexpr int FWD_F32_BN = 64;  // keys a streamed K/V tile

// Shared memory of an f32 forward instance, in floats: the K and V ring
// (a stage holds a tile's raw rows, then, split in place, their hi parts),
// the key-bias window of each stage, and the lo parts of the current K and
// V tiles (before the first tile: the block's raw Q rows).
template <int D, int NW, int BN>
struct FwdF32Layout {
  static constexpr int LD = D + 4;  // floats a tile row
  static constexpr int BR = 16 * NW;
  static constexpr int THREADS = 32 * NW;
  static constexpr int TILE = BN * LD;
  static constexpr int RING2 = F32_STAGES * TILE;      // V; K at 0
  static constexpr int WIN = 2 * F32_STAGES * TILE;    // key bias
  static constexpr int LO = WIN + F32_STAGES * BN;     // K lo, V lo
  static constexpr int BYTES = 4 * (LO + 2 * TILE);
  static_assert(BR <= 2 * BN, "the raw Q rows must fit the lo tiles");
};

// A warp's 16 rows of Q (Qw: its first row, f32 rows of D + 4) as the A
// fragments of every k-step, split into TF32 parts
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qh)[D / 8][4],
                                       uint32_t (&ql)[D / 8][4],
                                       const float* Qw, int lane) {
  const int a_off = a_frag_offset<D>(lane);
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    uint32_t raw[4];
    ldsm4(raw, Qw + a_off + 8 * kc);
    split_tf32(raw, qh[kc], ql[kc]);
  }
}

// S = Q K^T for a warp's 16 rows (qh, ql: load_q's fragments) against the
// BN keys of a streamed tile (Kh, Kl: its TF32 parts), D deep; C tile j
// covers keys 8j .. 8j + 7.
template <int D, int BN>
__device__ __forceinline__ void qk_scores(float (&s)[BN / 8][4],
                                          const uint32_t (&qh)[D / 8][4],
                                          const uint32_t (&ql)[D / 8][4],
                                          const uint32_t* Kh,
                                          const uint32_t* Kl, int lane) {
  constexpr int LD = D + 4;
  const int b_off = b_frag_offset<D>(lane);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      const int at = b_off + 16 * np * LD + 8 * kc;
      uint32_t bh[4], bl[4];
      ldsm4(bh, Kh + at);
      ldsm4(bl, Kl + at);
      mma3(s[2 * np], qh[kc], ql[kc], bh[0], bh[1], bl[0], bl[1]);
      mma3(s[2 * np + 1], qh[kc], ql[kc], bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// The online softmax of a warp's [16 rows x BN keys] score tile, in place:
// sc becomes P (f32), m (mrow: the thread's rows row and row + 8) and the
// lane's share of l (lrow) move on, corr rescales what came before (0 on
// a row's first tile).  Without HAS_BIAS, m is in base 2 (scores times
// scale_log2); with it, in nats (scores times scale plus the bias in
// nats).  EDGE: the tile crosses the warp's diagonal or S, so each
// element checks that its key is visible from its row.
template <bool HAS_BIAS, bool EDGE, int BN>
__device__ __forceinline__ void softmax_tile_f32(float (&sc)[BN / 8][4],
                                                 float (&mrow)[2],
                                                 float (&lrow)[2],
                                                 float (&corr)[2],
                                                 const float* bias_t,
                                                 float scale, float scale_log2,
                                                 int k0, int row, int t, int S,
                                                 int causal) {
  float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);  // key within the tile
      float x = sc[j][e];
      // a fully masked row's -1e30 ln 2 absorbs its scores: they tie
      if constexpr (HAS_BIAS) x = fmaf(x, scale, __fmul_rn(bias_t[c], bf16mma::LN2));
      if constexpr (EDGE) {
        const int key = k0 + c;
        // NEG_BIG lies below every biased score (-1e30 ln 2 at least)
        if (key >= S || (causal && key > row + 8 * (e >> 1))) x = NEG_BIG;
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if constexpr (!HAS_BIAS) mx[i] *= scale_log2;
    const float m_new = fmaxf(mrow[i], mx[i]);
    corr[i] = HAS_BIAS ? hopper::exp2_ftz((mrow[i] - m_new) * bf16mma::LOG2E)
                       : hopper::exp2_ftz(mrow[i] - m_new);
    mrow[i] = m_new;
    lrow[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = mrow[e >> 1];
      const float p =
          HAS_BIAS ? hopper::exp2_ftz((sc[j][e] - m) * bf16mma::LOG2E)
                   : hopper::exp2_ftz(fmaf(sc[j][e], scale_log2, -m));
      lrow[e >> 1] += p;
      sc[j][e] = p;
    }
  }
}

// One block per (b*h, tile of 16 NW query rows, last tile first); streams
// K/V tiles of BN keys.
template <int D, bool HAS_BIAS, int NW, int BN>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int S, int causal, float scale) {
  using L = FwdF32Layout<D, NW, BN>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [STAGES][BN][LD], raw, then hi
  float* Vs = smem + L::RING2;   // [STAGES][BN][LD], raw, then hi
  float* Bs = smem + L::WIN;     // [STAGES][BN] raw key bias
  uint32_t* Kl = reinterpret_cast<uint32_t*>(smem + L::LO);  // [BN][LD]
  uint32_t* Vl = Kl + L::TILE;                               // [BN][LD]
  float* Qraw = smem + L::LO;  // [BR][LD], until every warp has split its rows

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BR;  // last tile first
  // causal: keys past the block's last query row are never visible
  const int kend = causal ? min(S, q0 + L::BR) : S;
  const int ntiles = (kend + BN - 1) / BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = HAS_BIAS ? bias + (long long)b * S : nullptr;
  auto load_tile = [&](int kt) {
    const int s = kt % F32_STAGES;
    copy_rows<D, BN, L::THREADS>(Ks + s * L::TILE, kb, k_ss, kt * BN, S, tid);
    copy_rows<D, BN, L::THREADS>(Vs + s * L::TILE, vb, v_ss, kt * BN, S, tid);
    if constexpr (HAS_BIAS) {
      copy_window<BN, L::THREADS>(Bs + s * BN, biasb, kt * BN, S, tid);
    }
    bf16mma::cp_async_commit();
  };
  copy_rows<D, L::BR, L::THREADS>(Qraw, qb, q_ss, q0, S, tid);
  load_tile(0);  // one group: Q and the first tile
  bf16mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qh[D / 8][4], ql[D / 8][4];  // Q split once, kept in registers
  load_q<D>(qh, ql, Qraw + 16 * warp * LD, lane);

  const int r0 = q0 + 16 * warp;  // the warp's first row
  const int row = r0 + g;         // this thread's rows: row, row + 8
  // the tiles this warp computes: with causal masking, those that start at
  // or before its last row
  const int nact = r0 >= S ? 0
                   : causal ? min(ntiles, (r0 + 15) / BN + 1)
                            : ntiles;
  const float scale_log2 = scale * bf16mma::LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float mrow[2] = {-INFINITY, -INFINITY};
  float lrow[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % F32_STAGES;
    bf16mma::cp_async_wait<0>();
    // tile kt visible; every warp is done with tile kt - 1 (and, at kt = 0,
    // with Q's rows in the lo tiles)
    __syncthreads();
    if (kt + 1 < ntiles) load_tile(kt + 1);
    // split in place: the stage keeps the hi parts, the lo tiles the rest
    uint32_t* Kh = reinterpret_cast<uint32_t*>(Ks + s * L::TILE);
    uint32_t* Vh = reinterpret_cast<uint32_t*>(Vs + s * L::TILE);
    split_tile<D, BN, L::THREADS>(Kh, Kl, Ks + s * L::TILE, tid);
    split_tile<D, BN, L::THREADS>(Vh, Vl, Vs + s * L::TILE, tid);
    __syncthreads();  // the tile's TF32 parts visible
    if (kt >= nact) continue;  // warp-uniform: above the warp's rows
    const int k0 = kt * BN;
    float sc[BN / 8][4], corr[2];
    qk_scores<D, BN>(sc, qh, ql, Kh, Kl, lane);
    if (k0 + BN > S || (causal && k0 + BN - 1 > r0)) {
      softmax_tile_f32<HAS_BIAS, true, BN>(sc, mrow, lrow, corr, Bs + s * BN,
                                       scale, scale_log2, k0, row, t, S,
                                       causal);
    } else {
      softmax_tile_f32<HAS_BIAS, false, BN>(sc, mrow, lrow, corr, Bs + s * BN,
                                        scale, scale_log2, k0, row, t, S,
                                        causal);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    accumulate<D, BN>(acc, sc, Vh, Vl, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float ll = fmaxf(l, 1e-30f);  // fully masked rows stay finite
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * i] /= ll;
      acc[n][2 * i + 1] /= ll;
    }
    const int r = row + 8 * i;
    if (t == 0 && r < S) {
      lse[(long long)bh * S + r] = HAS_BIAS ? mrow[i] + logf(ll)
                                            : (mrow[i] + log2f(ll)) * bf16mma::LN2;
    }
  }
  store_rows_f32<D>(o, acc, b, h, H, S, row, t);
}

// Query rows a block of the f32 forward owns over B * H heads of S rows:
// 128 when S > 64 and that grid covers at least half the SMs (eight warps
// share each streamed tile), else 64 (more blocks spread a short grid over
// more SMs); 64 if the SM count cannot be read.  32-row blocks were slower
// at every shape timed (PERF.md).
int fwd_f32_block_rows(int B, int H, int S) {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 64;
  }
  return S > 64 && 2LL * B * H * ((S + 127) / 128) >= sms ? 128 : 64;
}

template <int D, bool HAS_BIAS, int NW>
int launch_fwd_f32_as(const float* q, const float* k, const float* v,
                      const float* bias,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh, float* o,
                      float* lse, int B, int H, int S, int causal, float scale,
                      cudaStream_t stream) {
  using L = FwdF32Layout<D, NW, FWD_F32_BN>;
  const auto kernel = flash_fwd_f32_kernel<D, HAS_BIAS, NW, FWD_F32_BN>;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err =
      hopper::configure_once(kernel, L::BYTES, L::THREADS, 0, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + L::BR - 1) / L::BR);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o,
      lse, H, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_f32(const float* q, const float* k, const float* v,
                   const float* bias,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, float* o,
                   float* lse, int B, int H, int S, int causal, float scale,
                   cudaStream_t stream) {
  const int rows = fwd_f32_block_rows(B, H, S);
#define FWD_AS(HB, NW_)                                                    \
  launch_fwd_f32_as<D, HB, NW_>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb,     \
                                k_ss, k_sh, v_sb, v_ss, v_sh, o, lse, B, H, \
                                S, causal, scale, stream)
  if (bias != nullptr) return rows == 128 ? FWD_AS(true, 8) : FWD_AS(true, 4);
  return rows == 128 ? FWD_AS(false, 8) : FWD_AS(false, 4);
#undef FWD_AS
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
#define FWD_D(D_)                                                          \
  launch_fwd_f32<D_>(q, k, v, bias, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
                     v_sb, v_ss, v_sh, o, lse, B, H, S, causal, scale, st)
  switch (D) {
    case 8:
      return FWD_D(8);
    case 16:
      return FWD_D(16);
    case 32:
      return FWD_D(32);
    case 64:
      return FWD_D(64);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_D
}

// The query rows a block of the f32 forward takes at (B, H, S) on the
// current device: 128 or 64 (see fwd_f32_block_rows).
extern "C" int flash_attention_fwd_f32_block_rows(int B, int H, int S) {
  return fwd_f32_block_rows(B, H, S);
}

// Dynamic shared memory, in bytes, of the f32 forward's instance for head
// dim D at `rows` query rows a block; -1 if there is no such instance.
// Neither the rows nor the bias change it.
extern "C" int flash_attention_fwd_f32_smem_bytes(int D, int rows) {
  if ((rows != 64 && rows != 128) ||
      (D != 8 && D != 16 && D != 32 && D != 64)) {
    return -1;
  }
  return 4 * ((2 * F32_STAGES + 2) * FWD_F32_BN * (D + 4) +
              F32_STAGES * FWD_F32_BN);
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
