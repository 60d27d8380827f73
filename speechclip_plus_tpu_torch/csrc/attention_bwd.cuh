// Fused attention block, backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_kernel` of
// speechclip_plus_tpu/nn/fused_attention_block_vjp.py:104 (launched by
// `_pallas_bwd`, :197): the backward of the branch self-attention, from the
// context cotangent dctx to dqkv, the cotangent of the packed (B, T, 3D)
// q|k|v buffer that K1's projection writes. dx = dqkv Wqkv, dWqkv and dbqkv
// stay plain matmuls and sums outside, as they are XLA in JAX (:382-390).
//
// What it computes, per (batch, head), with s = q k^T + key_bias + ab (q
// already scaled by 1/sqrt(dh) in K1's epilogue; ab the optional per-head
// additive bias (H | 1, T, T), `has_ab` in the Pallas kernel, :113, :153-154:
// the text tower's causal mask; it takes no gradient), p = softmax(s), mask
// m from the counter hash of dropout_mask.cuh (the forward's mask,
// regenerated) and w = p * m / keep:
//   dv = w^T dctx,  dp = (dctx v^T) * m / keep,  ds = p * (dp - D),
//   dk = ds^T q,    dq = scale * ds k
// with D_i = rowsum(dctx_i * ctx_i), which equals sum_j dp_ij p_ij with
// dropout too. The trailing `scale` is the chain rule of K1's q scale, so dq
// is the cotangent of the unscaled projection (JAX folds it into its
// packing, :457-470).
//
// What bounds it on the H100. The TPU kernel held a whole (T, T) fp32 score
// block per head in VMEM; at the branch shape (T = 321) that is 412 KB, more
// than an SM's 227 KB of shared memory. So this is a FlashAttention-2-style
// backward that never stores p: it recomputes p = exp(s - lse) from q, k and
// the per-row log-sum-exp K1 wrote, tile by tile, in two passes after D:
//   1. bwd_dvec_kernel: D (B, H, T) fp32, one warp per row.
//   2. the dk/dv pass: grid (key tile, head, batch); one walk over the query
//      tiles accumulates dk and dv in registers.
//   3. the dq pass: grid (query tile, head, batch); one walk over the key
//      tiles accumulates dq. dq stays its own pass: summing it across key
//      tiles with atomics would end bit-identical reruns.
// The score tile is therefore computed twice: 7 T x T x dh products for the 5
// the mathematics needs, at every head dim.
//
// The five products run on the tensor cores, from the pieces of
// attention_core.cuh (TF32 mma on the fp32 tiles; the three-pass split for fp32
// cotangents; for bf16 ones one pass, and in tiles that hold a large weight
// three passes in q k^T and two in dctx v^T and in w^T dctx: `LOG_PRECISE_ABOVE`
// says why; the fragment layouts are described there). Both passes are one
// kernel: a block owns 64 "own" rows (queries in
// the dq pass, keys in the dk/dv pass) and walks the "other" rows in tiles of
// 64. Its first two products are own1 other1^T and own2 other2^T with
//   dq pass:    own = (q, dctx), other = (k, v):  s   = q k^T,  dp   = dctx v^T
//   dk/dv pass: own = (k, v), other = (q, dctx):  s^T = k q^T,  dp^T = v dctx^T
// so the dk/dv pass holds the transposed tiles, and p, w and ds are formed in
// the accumulators. Under the permuted summed index those accumulators are
// the A operands of the second products (dq += ds k; dk += ds^T q,
// dv += w^T dctx), read against the other tiles where they lie: nothing goes
// back through shared memory, nothing is transposed. Each output element is
// summed by one lane in a fixed order: no float atomics, reruns are
// bit-identical. The other tiles of fp32 sources (q, k, v) come by `cp.async`,
// a whole tile in flight at once; the bf16 cotangent is widened through
// registers. A warp whose own rows all lie past T multiplies nothing.
//
// At dh = 128 (the large branches) the four (64, 132) fp32 tiles take 135 KB,
// one block an SM, and a thread of the dk/dv pass holds 128 output
// accumulators (dk and dv) and the 64 of the s and dp tiles.
//
// A head of dh = 768 (the cascaded branches) fits none of these tiles (four
// (64, 772) fp32 tiles are 790 KB), so, as in the forward, the head dim is cut
// across 8 warps, 96 columns each: a block owns 16 rows and walks the other
// rows 16 at a time; each warp sums the two (16, 16) product tiles over its
// own columns, the 8 partial tiles are added in a fixed order through shared
// memory, one thread per element forms w and ds, and each warp updates its
// own 96 columns of dq, or of dk and dv, both in registers (2 x 48 a thread).
// At dh = 1024 (the fixed-K large branches, one head over 1024) four (16,
// 1028) fp32 tiles are 263 KB, past the 227 KB of an SM. The block keeps its
// 16 own rows whole (2 x 65.8 KB) and walks the other rows 8 at a time (the n
// of the TF32 m16n8k8 product; 2 x 32.9 KB), 207 KB in all; half the threads
// form the (16, 8) elements of w and ds, and each warp holds its 128 columns
// of dk and dv in 2 x 64 registers a thread. The other rows are read from L2
// twice as often per own row as at 768 tiles: fitting first, speed later.
// Keys past T weigh 0; masked keys carry the caller's -1e30, never -inf.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_core.cuh"

// the entry point's arguments but dh and the cotangent type, with and without
// their types
#define SC_FAB_BWD_PARAMS                                                                 \
  const float *qkv, const float *key_bias, const float *ab, int ab_heads,                 \
      const void *dctx, const void *ctx, const float *lse, float *dvec,                   \
      const int64_t *seed, unsigned int keep_thresh, float inv_keep, float scale,         \
      void *dqkv, int B, int Tn, int H, cudaStream_t stream
#define SC_FAB_BWD_ARGS                                                                   \
  qkv, key_bias, ab, ab_heads, dctx, ctx, lse, dvec, seed, keep_thresh, inv_keep, scale,  \
      dqkv, B, Tn, H, stream

namespace {

struct BwdParams {
  const float* qkv;        // (B, T, 3 H dh) packed q | k | v, q scaled
  const float* key_bias;   // (B, T) additive
  const float* ab;         // (H | 1, T, T) additive per-head bias, or null
  int64_t ab_head_stride;  // T * T, or 0 when one bias serves every head
  const void* dctx;        // (B, T, H dh) context cotangent
  const float* lse;        // (B, H, T) the forward's log-sum-exp
  const float* dvec;       // (B, H, T) rowsum(dctx * ctx)
  const int64_t* seed;     // device [seed, offset], or null: no dropout
  uint32_t keep_thresh;
  float inv_keep;
  float scale;             // the q scale, applied to dq
  void* dqkv;              // (B, T, 3 H dh)
  int T, H;
  int vec;                 // dctx takes 16-byte loads (qkv always does)
};

// D[b, h, t] = sum_c dctx[b, t, h*DH + c] * ctx[b, t, h*DH + c]; one warp per
// (b, t, h), lanes strided over the head dim, summed in a fixed order
template <typename TG>
__global__ void bwd_dvec_kernel(const TG* __restrict__ dctx, const TG* __restrict__ ctx,
                                float* __restrict__ dvec, int B, int Tn, int H, int DH) {
  const int idx = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;  // (b, t, h)
  if (idx >= B * Tn * H) return;
  const int lane = threadIdx.x % 32;
  const int h = idx % H, bt = idx / H, t = bt % Tn, b = bt / Tn;
  const size_t o = (size_t)bt * H * DH + (size_t)h * DH;
  float acc = 0.f;
  for (int c = lane; c < DH; c += 32) acc = fmaf(to_f(dctx[o + c]), to_f(ctx[o + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[((size_t)b * H + h) * Tn + t] = acc;
}

// p, the dropped-and-scaled weight w and ds of one score element, from the
// two product sums. (qi, kj) is the element's (query, key).
struct ScoreGrad {
  float w, ds;
};
__device__ __forceinline__ ScoreGrad score_grad(float s, float dp, float bias, float lse, float d,
                                                bool in, bool drop, bool keep, float inv_keep) {
  const float p = in ? expf(s + bias - lse) : 0.f;  // nothing outside T x T
  float w = p, dpv = dp;
  if (drop) {
    w = keep ? p * inv_keep : 0.f;
    dpv = keep ? dp * inv_keep : 0.f;
  }
  return {w, p * (dpv - d)};
}

// Precision where the output is bf16. In a short sequence every query's
// weight sits on a few keys, and what a key receives is a sum over every query
// of terms of order 1, held to 2e-2 x the RMS of a mostly empty dqkv. There
// p = exp(s - lse) must be normalized to the forward's lse (1e-3 in s is 1e-3
// of sum_i |dctx_i| in dv), so q k^T takes the three passes; ds = p (dp - D)
// cancels (p near 1, dp near D), leaving the error of dp itself, about 4e-3
// for one TF32 pass, to add up into dk; and w = 1 / keep is not a TF32 value,
// so its rounding, 2.4e-4 of each term, adds up over the queries into dv.
// Where no weight is large none of this shows: one pass leaves each output
// 1e-3 of its own size off, inside its bf16 rounding. So at dh <= 128 the
// precision is chosen per tile: a warp multiplies its (16 own, 64 other) tile
// in one pass, and only where some p of the tile exceeds PRECISE_ABOVE does it
// multiply with the compensated passes below (q k^T a second time). The choice
// depends on the data alone, so reruns stay bit-identical. The threshold is
// a quarter: the numerical model (nn/attention_numerics.py) stays under half
// the tolerance up to a half, and a warp that takes the compensated passes
// holds its block at the next barrier, so a lower one is paid for by every
// warp (at an eighth 4 % of random full-length tiles qualify and the kernel
// is a third slower, at a quarter 0.2 %). At dh = 768 every tile takes the
// compensated passes: that kernel waits on L2, not on its products.
constexpr float LOG_PRECISE_ABOVE = -1.3862944f;  // PRECISE_ABOVE = 0.25
// Past PRECISE_BEYOND_T keys every tile takes the compensated passes. Where
// the weights are flat, the one-pass error of dq, dk and dv grows with the
// number of keys summed: at B=128 and dh=64 it is 1.97e-2 x RMS beyond half a
// bf16 ulp at T=639 (1.69e-2 at dh=96, T=329), against a tolerance of 2e-2;
// compensated everywhere 5.5e-3, for an eighth to a quarter more time on an
// H100 (scripts/torch_k2_precision_variants.py, precise_only). T up to 6 key
// tiles (the HuBERT-family branches, T <= 329) keeps the choice per tile. The
// launcher picks the kernel instance by T (ALL_PRECISE): the same choice made
// at run time inside the kernel keeps both code paths live, and took a third
// more time than the instance without the one-pass path.
constexpr int PRECISE_BEYOND_T = 384;

// The compensated dp += dctx v^T (the dq pass: a is dctx, b is v) or
// dp^T += v dctx^T (the dk/dv pass). The bf16 cotangent is exact in TF32, so
// dp splits v alone: two passes, as exact as three.
template <bool P3, bool OWN_Q>
__device__ __forceinline__ void mma_dp(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  if (P3)
    mma_f<true, true>(c, a, b);
  else
    mma_split<!OWN_Q>(c, a, b);
}

// The compensated dv += w^T dctx: the cotangent is exact in TF32, so w split
// in two makes the product exact for two passes.
template <bool P3>
__device__ __forceinline__ void mma_dv(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  if (P3)
    mma_f<true, true>(c, a, b);
  else
    mma_split<true>(c, a, b);
}

// ----------------------------------------------------- dh = 64, 96 and 128 ----

constexpr int BT = 64, B_THREADS = 128;  // 64 x 64 (own, other) tiles, 4 warps

template <int DH>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * BT * (DH + 4) + 2 * BT);
}

// One of the first two products of a warp's tile, s = own1 other1^T or (DP)
// dp = own2 other2^T, from zero: with the compensated passes (PRECISE), or in
// one pass on operands rounded to TF32 as they are loaded.
template <bool OWN_Q, bool P3, bool PRECISE, bool DP, int DH>
__device__ __forceinline__ void first_product(float (&c)[BT / 8][4], const float* a_rows,
                                              const float* B, int g, int t) {
  constexpr int LD = DH + 4, KS = DH / 8, NJ = BT / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float a[4];
    load_a(a, a_rows + ks * 8 + t, LD);
    if (!PRECISE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = op_round<false>(a[i]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float b[2];
      load_bt<PRECISE>(b, B + (j * 8 + g) * LD + ks * 8 + t);
      if (!PRECISE)
        mma_f<false>(c[j], a, b);
      else if (DP)
        mma_dp<P3, OWN_Q>(c[j], a, b);
      else
        mma_f<true, P3>(c[j], a, b);
    }
  }
}

// The second products of one 8-deep step: dq += ds k, or dk += ds^T q and
// dv += w^T dctx, the accumulators ds and w being the A operands; dv with w
// split in two (PRECISE) or rounded.
template <bool OWN_Q, bool P3, bool PRECISE, int DH>
__device__ __forceinline__ void second_products(float (&acc1)[DH / 8][4],
                                                float (&acc2)[OWN_Q ? 1 : DH / 8][4],
                                                const float (&ds)[4], const float (&w)[4],
                                                const float* b1_rows, const float* b2_rows,
                                                int g) {
  constexpr int LD = DH + 4, KS = DH / 8;
  float a1[4], a2[4];
  acc_as_a<P3>(a1, ds);
  if constexpr (!OWN_Q) acc_as_a<PRECISE>(a2, w);  // as it is where `mma_dv` splits it
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    float bb[2];
    load_bp<P3>(bb, b1_rows + n * 8 + g, LD);
    mma_f<P3, P3>(acc1[n], a1, bb);
    if constexpr (!OWN_Q) {
      load_bp<true>(bb, b2_rows + n * 8 + g, LD);  // the bf16 cotangent, exact in TF32
      if (PRECISE)
        mma_dv<P3>(acc2[n], a2, bb);
      else
        mma_f<false>(acc2[n], a2, bb);
    }
  }
}

// OWN_Q: the dq pass (own rows are queries), else the dk/dv pass (own rows
// are keys). Warp w owns rows 16 w + g and 16 w + g + 8 of the block's 64; the
// product accumulators hold other rows 8 j + 2t, 2t + 1 (j < 8), the output
// accumulators head columns 8 n + 2t, 2t + 1.
// ALL_PRECISE: every tile takes the compensated passes (T > PRECISE_BEYOND_T).
template <bool OWN_Q, typename TG, int DH, bool ALL_PRECISE>
__global__ void __launch_bounds__(B_THREADS, blocks_per_sm<bwd_smem_bytes<DH>()>())
attention_bwd_kernel(const BwdParams p) {
  constexpr bool P3 = std::is_same<TG, float>::value;
  constexpr int LD = DH + 4, KS = DH / 8, NJ = BT / 8;
  extern __shared__ __align__(16) float smem[];
  float* A1 = smem;            // own rows: q (dq pass) or k
  float* A2 = A1 + BT * LD;    //           dctx         or v
  float* B1 = A2 + BT * LD;    // other rows: k (dq pass) or q
  float* B2 = B1 + BT * LD;    //             v           or dctx
  float* lse_s = B2 + BT * LD; // dk/dv pass: lse and D of the query tile
  float* d_s = lse_s + BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H, D = H * DH;
  const int64_t rs3 = 3 * (int64_t)D;
  const float* qb = p.qkv + (size_t)b * Tn * rs3 + (size_t)h * DH;
  const float* kbase = qb + D;
  const float* vbase = qb + 2 * D;
  const TG* gbase = static_cast<const TG*>(p.dctx) + (size_t)b * Tn * D + (size_t)h * DH;
  const float* kb = p.key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const float* abh = p.ab != nullptr ? p.ab + h * p.ab_head_stride : nullptr;
  const bool drop = p.seed != nullptr;
  uint32_t sd = 0, offset = 0;
  if (drop) {
    sd = (uint32_t)p.seed[0];
    offset = (uint32_t)p.seed[1];
  }

  if (OWN_Q) {
    fill_tile<BT, DH, LD, true, B_THREADS>(A1, qb, rs3, o0, Tn, true);
    fill_tile<BT, DH, LD, true, B_THREADS>(A2, gbase, (int64_t)D, o0, Tn, p.vec);
  } else {
    fill_tile<BT, DH, LD, true, B_THREADS>(A1, kbase, rs3, o0, Tn, true);
    fill_tile<BT, DH, LD, true, B_THREADS>(A2, vbase, rs3, o0, Tn, true);
  }

  // per own row (r0 and r0 + 8): its index, its half of the mask key, and
  // the per-row scalars of the pass
  const int r0 = warp * 16 + g;
  const bool live = o0 + warp * 16 < Tn;
  int own[2];
  uint32_t own_key[2] = {0, 0};
  float own_lse[2] = {0.f, 0.f}, own_d[2] = {0.f, 0.f}, own_kb[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    own[i] = o0 + r0 + 8 * i;
    const int tc = min(own[i], Tn - 1);  // rows past T are computed and dropped
    if (OWN_Q) {
      own_lse[i] = p.lse[bh + tc];
      own_d[i] = p.dvec[bh + tc];
    } else {
      own_kb[i] = kb[tc];
    }
    if (drop)
      own_key[i] = OWN_Q ? sc_row_key(sd, (int64_t)bh + own[i]) : sc_col_key(offset, own[i]);
  }

  float acc1[KS][4], acc2[OWN_Q ? 1 : KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc1[n][c] = 0.f;
      if constexpr (!OWN_Q) acc2[n][c] = 0.f;
    }

  for (int t0 = 0; t0 < Tn; t0 += BT) {
    __syncthreads();  // the previous tile's other rows are consumed
    if (OWN_Q) {
      tile_start<BT, DH, LD, B_THREADS>(B1, kbase, rs3, t0, Tn, true);
      tile_start<BT, DH, LD, B_THREADS>(B2, vbase, rs3, t0, Tn, true);
      tile_finish<BT, DH, LD, B_THREADS>(B1, kbase, rs3, t0, Tn, true);
      tile_finish<BT, DH, LD, B_THREADS>(B2, vbase, rs3, t0, Tn, true);
    } else {
      tile_start<BT, DH, LD, B_THREADS>(B1, qb, rs3, t0, Tn, true);
      tile_start<BT, DH, LD, B_THREADS>(B2, gbase, (int64_t)D, t0, Tn, p.vec);
      tile_finish<BT, DH, LD, B_THREADS>(B2, gbase, (int64_t)D, t0, Tn, p.vec);
      tile_finish<BT, DH, LD, B_THREADS>(B1, qb, rs3, t0, Tn, true);
      if (tid < BT) {
        const bool in = t0 + tid < Tn;
        lse_s[tid] = in ? p.lse[bh + t0 + tid] : 0.f;
        d_s[tid] = in ? p.dvec[bh + t0 + tid] : 0.f;
      }
    }
    __syncthreads();

    if (!live) continue;  // all of the warp's own rows lie past T
    // z = s + bias - lse (p = exp z), in one pass first, with the compensated
    // passes where the tile holds a large weight (fp32 cotangents take them
    // always). The choice needs no exponential and comes before dp is
    // multiplied, so that the work on the elements below still overlaps the
    // second products.
    float s[NJ][4], dp[NJ][4];
    bool precise = P3 || ALL_PRECISE;
    for (;;) {
      if constexpr (P3)
        first_product<OWN_Q, true, true, false, DH>(s, A1 + r0 * LD, B1, g, t);
      else if (precise)
        first_product<OWN_Q, false, true, false, DH>(s, A1 + r0 * LD, B1, g, t);
      else
        first_product<OWN_Q, false, false, false, DH>(s, A1 + r0 * LD, B1, g, t);
      float z_max = INIT_MAX;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jj = j * 8 + 2 * t + c, oth = t0 + jj;
          const float oth_kb = OWN_Q ? kb[min(oth, Tn - 1)] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool in = own[i] < Tn && oth < Tn;
            float bias = OWN_Q ? oth_kb : own_kb[i];
            if (abh != nullptr && in)
              bias += abh[(size_t)(OWN_Q ? own[i] : oth) * Tn + (OWN_Q ? oth : own[i])];
            // nothing outside T x T: exp(INIT_MAX) is 0
            const float z = in ? s[j][2 * i + c] + bias - (OWN_Q ? own_lse[i] : lse_s[jj])
                               : INIT_MAX;
            s[j][2 * i + c] = z;
            z_max = fmaxf(z_max, z);
          }
        }
      if (precise || !__any_sync(0xffffffffu, z_max > LOG_PRECISE_ABOVE)) break;
      precise = true;
    }
    if constexpr (P3)
      first_product<OWN_Q, true, true, true, DH>(dp, A2 + r0 * LD, B2, g, t);
    else if (precise)
      first_product<OWN_Q, false, true, true, DH>(dp, A2 + r0 * LD, B2, g, t);
    else
      first_product<OWN_Q, false, false, true, DH>(dp, A2 + r0 * LD, B2, g, t);

    // z -> ds and dp -> w in place; the mask is keyed by (query row, key
    // column), whichever is "own"
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = j * 8 + 2 * t + c, oth = t0 + jj;
        uint32_t oth_key = 0;
        if (drop) oth_key = OWN_Q ? sc_col_key(offset, oth) : sc_row_key(sd, (int64_t)bh + oth);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool keep = drop && sc_keep(OWN_Q ? own_key[i] : oth_key,
                                            OWN_Q ? oth_key : own_key[i], p.keep_thresh);
          const ScoreGrad r = score_grad(s[j][2 * i + c], dp[j][2 * i + c], 0.f, 0.f,
                                         OWN_Q ? own_d[i] : d_s[jj], true, drop, keep, p.inv_keep);
          s[j][2 * i + c] = r.ds;
          dp[j][2 * i + c] = r.w;
        }
      }

#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b1_rows = B1 + (j * 8 + 2 * t) * LD;
      const float* b2_rows = B2 + (j * 8 + 2 * t) * LD;
      if constexpr (P3)
        second_products<OWN_Q, true, true, DH>(acc1, acc2, s[j], dp[j], b1_rows, b2_rows, g);
      else if (precise)
        second_products<OWN_Q, false, true, DH>(acc1, acc2, s[j], dp[j], b1_rows, b2_rows, g);
      else
        second_products<OWN_Q, false, false, DH>(acc1, acc2, s[j], dp[j], b1_rows, b2_rows, g);
    }
  }

  TG* out = static_cast<TG*>(p.dqkv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (own[i] >= Tn) continue;
    TG* row = out + ((size_t)b * Tn + own[i]) * rs3 + (size_t)h * DH + (OWN_Q ? 0 : D);
    const float f = OWN_Q ? p.scale : 1.f;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        row[n * 8 + 2 * t + c] = from_f<TG>(acc1[n][2 * i + c] * f);
        if constexpr (!OWN_Q) row[D + n * 8 + 2 * t + c] = from_f<TG>(acc2[n][2 * i + c]);
      }
  }
}

// -------------------------------------------------------- dh = 768 and 1024 ----

constexpr int XT = 16, X_THREADS = 256, X_WARPS = 8;

// other rows a step: 16 at dh = 768, 8 at dh = 1024 (the note above)
template <int DH>
__host__ __device__ constexpr int bwd_wide_other() {
  return DH > 768 ? 8 : 16;
}

// row stride of the (16, other) tiles, so that the 8-byte accesses of a half
// warp (rows g < 4, columns 2t) and the element role's loads spread over the
// banks: 24 for 16 columns, 8 for 8
template <int DH>
__host__ __device__ constexpr int bwd_wide_lp() {
  return bwd_wide_other<DH>() == 16 ? 24 : 8;
}

template <int DH>
constexpr size_t bwd_wide_smem_bytes() {
  return sizeof(float) * (2 * (XT + bwd_wide_other<DH>()) * (DH + 4) +
                          (2 * X_WARPS + 2) * XT * bwd_wide_lp<DH>());
}
static_assert(bwd_wide_smem_bytes<768>() <= 232448, "dh = 768 fits an SM");
static_assert(bwd_wide_smem_bytes<1024>() <= 232448, "dh = 1024 fits an SM");

// Warp w owns head columns [w DH / 8, (w + 1) DH / 8) of every operand and of
// the outputs, for all 16 own rows. Thread tid < 16 XO forms the element (own
// row tid / XO, other row tid % XO) of w and ds.
template <bool OWN_Q, typename TG, int DH>
__global__ void __launch_bounds__(X_THREADS, 1) attention_bwd_wide_kernel(const BwdParams p) {
  constexpr bool P3 = std::is_same<TG, float>::value;
  constexpr int XO = bwd_wide_other<DH>(), LP = bwd_wide_lp<DH>();
  constexpr int LD = DH + 4, CW = DH / X_WARPS, KS = CW / 8, NJ = XO / 8, TILE = XT * LP;
  extern __shared__ __align__(16) float smem[];
  float* A1 = smem;
  float* A2 = A1 + XT * LD;
  float* B1 = A2 + XT * LD;
  float* B2 = B1 + XO * LD;
  float* Part = B2 + XO * LD;             // per warp: its s tile, then its dp tile
  float* Ds = Part + 2 * X_WARPS * TILE;  // ds as [own][other]
  float* Ws = Ds + TILE;                  // w  as [own][other] (dk/dv pass)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * XT, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H, D = H * DH;
  const int64_t rs3 = 3 * (int64_t)D;
  const float* qb = p.qkv + (size_t)b * Tn * rs3 + (size_t)h * DH;
  const float* kbase = qb + D;
  const float* vbase = qb + 2 * D;
  const TG* gbase = static_cast<const TG*>(p.dctx) + (size_t)b * Tn * D + (size_t)h * DH;
  const float* kb = p.key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const float* abh = p.ab != nullptr ? p.ab + h * p.ab_head_stride : nullptr;
  const bool drop = p.seed != nullptr;
  uint32_t sd = 0, offset = 0;
  if (drop) {
    sd = (uint32_t)p.seed[0];
    offset = (uint32_t)p.seed[1];
  }

  if (OWN_Q) {
    fill_tile<XT, DH, LD, true, X_THREADS>(A1, qb, rs3, o0, Tn, true);
    fill_tile<XT, DH, LD, true, X_THREADS>(A2, gbase, (int64_t)D, o0, Tn, p.vec);
  } else {
    fill_tile<XT, DH, LD, true, X_THREADS>(A1, kbase, rs3, o0, Tn, true);
    fill_tile<XT, DH, LD, true, X_THREADS>(A2, vbase, rs3, o0, Tn, true);
  }

  // the element role: own row ei, other row ej of every tile
  const bool elem = tid < XT * XO;
  const int ei = min(tid / XO, XT - 1), ej = tid % XO;
  const int own = o0 + ei, own_c = min(own, Tn - 1);
  const float own_lse = OWN_Q ? p.lse[bh + own_c] : 0.f;
  const float own_d = OWN_Q ? p.dvec[bh + own_c] : 0.f;
  const float own_kb = OWN_Q ? 0.f : kb[own_c];
  uint32_t own_key = 0;
  if (drop) own_key = OWN_Q ? sc_row_key(sd, (int64_t)bh + own) : sc_col_key(offset, own);

  float acc1[KS][4], acc2[OWN_Q ? 1 : KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc1[n][c] = 0.f;
      if constexpr (!OWN_Q) acc2[n][c] = 0.f;
    }

  for (int t0 = 0; t0 < Tn; t0 += XO) {
    __syncthreads();  // the previous tile's other rows, w and ds are consumed
    if (OWN_Q) {
      tile_start<XO, DH, LD, X_THREADS>(B1, kbase, rs3, t0, Tn, true);
      tile_start<XO, DH, LD, X_THREADS>(B2, vbase, rs3, t0, Tn, true);
      tile_finish<XO, DH, LD, X_THREADS>(B1, kbase, rs3, t0, Tn, true);
      tile_finish<XO, DH, LD, X_THREADS>(B2, vbase, rs3, t0, Tn, true);
    } else {
      tile_start<XO, DH, LD, X_THREADS>(B1, qb, rs3, t0, Tn, true);
      tile_start<XO, DH, LD, X_THREADS>(B2, gbase, (int64_t)D, t0, Tn, p.vec);
      tile_finish<XO, DH, LD, X_THREADS>(B2, gbase, (int64_t)D, t0, Tn, p.vec);
      tile_finish<XO, DH, LD, X_THREADS>(B1, qb, rs3, t0, Tn, true);
    }
    __syncthreads();

    {  // this warp's share of the two product tiles: its own columns
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = warp * CW + ks * 8 + t;
        float a1[4], a2[4];
        load_a(a1, A1 + g * LD + col, LD);
        load_a(a2, A2 + g * LD + col, LD);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float b1[2], b2[2];
          load_bt<true>(b1, B1 + (j * 8 + g) * LD + col);
          load_bt<true>(b2, B2 + (j * 8 + g) * LD + col);
          mma_f<true, P3>(s[j], a1, b1);
          mma_dp<P3, OWN_Q>(dp[j], a2, b2);
        }
      }
      float* ps = Part + 2 * warp * TILE;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = j * 8 + 2 * t;
        *reinterpret_cast<float2*>(ps + g * LP + c) = make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(ps + (g + 8) * LP + c) = make_float2(s[j][2], s[j][3]);
        *reinterpret_cast<float2*>(ps + TILE + g * LP + c) = make_float2(dp[j][0], dp[j][1]);
        *reinterpret_cast<float2*>(ps + TILE + (g + 8) * LP + c) =
            make_float2(dp[j][2], dp[j][3]);
      }
    }
    __syncthreads();

    if (elem) {  // the 8 partial tiles in a fixed order, then w and ds of one element
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int w = 0; w < X_WARPS; ++w) {
        s += Part[2 * w * TILE + ei * LP + ej];
        dp += Part[(2 * w + 1) * TILE + ei * LP + ej];
      }
      const int oth = t0 + ej, oth_c = min(oth, Tn - 1);
      const bool in = own < Tn && oth < Tn;
      float bias = OWN_Q ? kb[oth_c] : own_kb;
      if (abh != nullptr && in) bias += abh[(size_t)(OWN_Q ? own : oth) * Tn + (OWN_Q ? oth : own)];
      bool keep = false;
      if (drop) {
        const uint32_t oth_key =
            OWN_Q ? sc_col_key(offset, oth) : sc_row_key(sd, (int64_t)bh + oth);
        keep = sc_keep(OWN_Q ? own_key : oth_key, OWN_Q ? oth_key : own_key, p.keep_thresh);
      }
      const ScoreGrad r = score_grad(s, dp, bias, OWN_Q ? own_lse : p.lse[bh + oth_c],
                                     OWN_Q ? own_d : p.dvec[bh + oth_c], in, drop, keep,
                                     p.inv_keep);
      Ds[ei * LP + ej] = op_round<P3>(r.ds);
      if constexpr (!OWN_Q) Ws[ei * LP + ej] = r.w;  // as it is: `mma_dv` splits it
    }
    __syncthreads();

    // dq += ds k, or dk += ds^T q and dv += w^T dctx, on this warp's columns
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      const int c = kk * 8 + 2 * t;
      float a1[4], a2[4];
      {
        const float2 lo = *reinterpret_cast<const float2*>(Ds + g * LP + c);
        const float2 hi = *reinterpret_cast<const float2*>(Ds + (g + 8) * LP + c);
        a1[0] = lo.x; a1[1] = hi.x; a1[2] = lo.y; a1[3] = hi.y;
      }
      if constexpr (!OWN_Q) {
        const float2 lo = *reinterpret_cast<const float2*>(Ws + g * LP + c);
        const float2 hi = *reinterpret_cast<const float2*>(Ws + (g + 8) * LP + c);
        a2[0] = lo.x; a2[1] = hi.x; a2[2] = lo.y; a2[3] = hi.y;
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float bb[2];
        load_bp<P3>(bb, B1 + c * LD + warp * CW + n * 8 + g, LD);
        mma_f<P3, P3>(acc1[n], a1, bb);
        if constexpr (!OWN_Q) {
          load_bp<true>(bb, B2 + c * LD + warp * CW + n * 8 + g, LD);
          mma_dv<P3>(acc2[n], a2, bb);
        }
      }
    }
  }

  TG* out = static_cast<TG*>(p.dqkv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tr = o0 + g + 8 * i;
    if (tr >= Tn) continue;
    TG* row = out + ((size_t)b * Tn + tr) * rs3 + (size_t)h * DH + (OWN_Q ? 0 : D) + warp * CW;
    const float f = OWN_Q ? p.scale : 1.f;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        row[n * 8 + 2 * t + c] = from_f<TG>(acc1[n][2 * i + c] * f);
        if constexpr (!OWN_Q) row[D + n * 8 + 2 * t + c] = from_f<TG>(acc2[n][2 * i + c]);
      }
  }
}

// The dk/dv pass and the dq pass of the kernel at DH <= 128.
template <typename TG, int DH, bool ALL_PRECISE>
cudaError_t launch_tiles(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<false, TG, DH, ALL_PRECISE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_kernel<true, TG, DH, ALL_PRECISE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BT - 1) / BT, p.H, B);
  attention_bwd_kernel<false, TG, DH, ALL_PRECISE><<<grid, B_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<true, TG, DH, ALL_PRECISE><<<grid, B_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// D, then the dk/dv pass and the dq pass
template <typename TG, int DH>
cudaError_t launch_bwd(BwdParams p, const void* ctx, float* dvec, int B, cudaStream_t stream) {
  const TG* g = static_cast<const TG*>(p.dctx);
  const int64_t D = (int64_t)p.H * DH;
  p.vec = rows_take_vector_loads<TG>(g, p.T * D, DH, D);
  const int rows = B * p.T * p.H;
  bwd_dvec_kernel<TG><<<(rows + 7) / 8, 256, 0, stream>>>(g, static_cast<const TG*>(ctx), dvec,
                                                         B, p.T, p.H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (DH > 128) {
    constexpr size_t smem = bwd_wide_smem_bytes<DH>();
    err = cudaFuncSetAttribute(attention_bwd_wide_kernel<false, TG, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_wide_kernel<true, TG, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.T + XT - 1) / XT, p.H, B);
    attention_bwd_wide_kernel<false, TG, DH><<<grid, X_THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_bwd_wide_kernel<true, TG, DH><<<grid, X_THREADS, smem, stream>>>(p);
  } else {
    if constexpr (!std::is_same<TG, float>::value) {  // fp32 cotangents: precise always
      if (p.T > PRECISE_BEYOND_T) return launch_tiles<TG, DH, true>(p, B, stream);
    }
    return launch_tiles<TG, DH, false>(p, B, stream);
  }
  return cudaGetLastError();
}

// The backward for cotangents of type TG at head dim DH, from the entry
// point's arguments (fused_attention_block_bwd.cu says what they are).
template <typename TG, int DH>
cudaError_t attention_bwd(SC_FAB_BWD_PARAMS) {
  if (B <= 0 || Tn <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (ab != nullptr && ab_heads != 1 && ab_heads != H) return cudaErrorInvalidValue;
  // the packed qkv rows are read with 16-byte loads
  if (reinterpret_cast<uintptr_t>(qkv) % 16) return cudaErrorInvalidValue;
  BwdParams p = {};
  p.qkv = qkv;
  p.key_bias = key_bias;
  p.ab = ab;
  p.ab_head_stride = ab_heads == 1 ? 0 : (int64_t)Tn * Tn;
  p.dctx = dctx;
  p.lse = lse;
  p.dvec = dvec;
  p.seed = seed;
  p.keep_thresh = keep_thresh;
  p.inv_keep = inv_keep;
  p.scale = scale;
  p.dqkv = dqkv;
  p.T = Tn;
  p.H = H;
  return launch_bwd<TG, DH>(p, ctx, dvec, B, stream);
}

// a bf16 or an fp32 cotangent at head dim DH
template <int DH>
int attention_bwd_at(SC_FAB_BWD_PARAMS, int g_bf16) {
  return (int)(g_bf16 ? attention_bwd<bf16, DH>(SC_FAB_BWD_ARGS)
                      : attention_bwd<float, DH>(SC_FAB_BWD_ARGS));
}

}  // namespace
