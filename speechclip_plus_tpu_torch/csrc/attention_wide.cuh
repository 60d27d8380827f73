// Attention forward and backward for a head wider than shared memory allows
// in one piece (dh = 768: the cascaded branches run one head over the whole
// model width), for the fused attention block (K1, fused_attention_block.cu)
// and its backward (K2, fused_attention_block_bwd.cu).
//
// Replaces, at that width, the attention part of the Pallas kernels
// `_kernel` (speechclip_plus_tpu/nn/fused_attention_block.py:118) and
// `_bwd_kernel` (speechclip_plus_tpu/nn/fused_attention_block_vjp.py:104),
// which run the shape as one 768-wide head per batch row.
//
// What bounds it on the H100. The kernels for dh = 64 and 96 keep whole
// (64, dh) tiles of q, k, v in shared memory and a thread's output row slice
// in registers; at dh = 768 one such tile is 197 KB and K2 needs four. So the
// head dim is cut into chunks of 64 columns. One block owns 32 "own" rows of
// one (batch, head) and walks the "other" rows in tiles of 64:
//   1. the (32, 64) score tile (and, in the backward, the dctx v^T tile) is
//      accumulated in registers over the chunks, streaming (32, 64) and
//      (64, 64) chunk tiles of the operands through shared memory;
//   2. the softmax step (forward: online, fp32 running max and sum; backward:
//      p = exp(s - lse) from the forward's log-sum-exp), the dropout mask and
//      ds give a (32, 64) weight tile in shared memory;
//   3. the output (32, dh) fp32 accumulator lives in shared memory (99 KB)
//      and is updated one 64-column chunk at a time from (64, 64) chunk tiles
//      of the other rows' v (forward), k (dq), q (dk) or dctx (dv).
// Four modes share that skeleton: the forward (own = queries), dq (own =
// queries), dk and dv (own = keys; the tile is the transposed one). dk and dv
// are two launches because two (32, 768) accumulators and the chunk tiles do
// not fit 227 KB; the score tile is therefore recomputed in each of the three
// backward launches (8 T x T x dh products against the 5 the mathematics
// needs). Every output element is summed by one thread in a fixed order: no
// atomics, reruns are bit-identical. Masked keys carry the caller's -1e30,
// keys past T carry -2e30 in the forward and weight 0 in the backward, never
// -inf. Simple first: fp32 FMAs from shared memory, nothing pipelined.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_mask.cuh"
#include "numeric.cuh"

namespace {

enum WideMode { WIDE_FWD = 0, WIDE_DQ = 1, WIDE_DK = 2, WIDE_DV = 3 };

constexpr int WO = 32, WT = 64, WC = 64, W_THREADS = 256;
constexpr int W_LT = WC + 1;  // row stride of a chunk tile
constexpr int W_LW = WT + 1;  // row stride of the weight tile
constexpr float W_RAGGED_KEY = -2e30f;  // below the -1e30 padding bias
constexpr float W_INIT_MAX = -3e38f;

struct WideParams {
  const float* qkv;        // (B, T, 3 H dh) packed q | k | v, q scaled
  const float* key_bias;   // (B, T) additive
  const float* ab;         // (H | 1, T, T) additive per-head bias, or null
  int64_t ab_head_stride;  // T * T, or 0 when one bias serves every head
  const float* gate;       // forward: (B, H, T) factor on ab, or null
  const int64_t* seed;     // device [seed, offset], or null: no dropout
  uint32_t keep_thresh;
  float inv_keep;
  float* lse;              // (B, H, T): forward output (or null), backward input
  const void* dctx;        // backward: (B, T, H dh) context cotangent
  const float* dvec;       // backward: (B, H, T) rowsum(dctx * ctx)
  void* out;               // forward: ctx (B, T, H dh); backward: dqkv (B, T, 3 H dh)
  float scale;             // backward: the q scale, applied to dq
  int T, H;
};

template <int MODE, int DH>
constexpr size_t wide_smem_bytes() {
  return sizeof(float) * ((MODE == WIDE_DQ || MODE == WIDE_DK ? 2 : 1) * (WO + WT) * W_LT +
                          WO * W_LW + WO * (DH + 8));
}

// columns [c0, c0 + 64) of rows [r0, r0 + ROWS) of one (batch, head) slice
// into a (ROWS, LD) fp32 tile, zero past Tn
template <int ROWS, int LD, typename T>
__device__ __forceinline__ void wide_load(float* dst, const T* src, size_t row_stride,
                                          int r0, int c0, int Tn) {
  for (int e = threadIdx.x; e < ROWS * WC; e += W_THREADS) {
    const int r = e / WC, c = e % WC, t = r0 + r;
    dst[r * LD + c] = t < Tn ? to_f(src[(size_t)t * row_stride + c0 + c]) : 0.f;
  }
}

// Thread (ty, tx), ty < 16, tx < 16, owns own rows ty*2 + i (i < 2); in the
// weight tile it owns other rows tx + 16 j (j < 4), in the output the columns
// c0 + tx + 16 c (c < 4) of every chunk. The 16 threads of a row group are
// one half of a warp, so row reductions are xor-shuffles with offsets below
// 16. TG is the type of ctx, dctx and dqkv.
template <int MODE, typename TG, int DH, bool HAS_AB>
__global__ void __launch_bounds__(W_THREADS) wide_attention_kernel(const WideParams p) {
  extern __shared__ float smem[];
  constexpr bool TWO = MODE == WIDE_DQ || MODE == WIDE_DK;
  constexpr bool OWN_Q = MODE == WIDE_FWD || MODE == WIDE_DQ;
  constexpr int LDO = DH + 8;
  float* As = smem;               // own rows of the first product, one chunk
  float* Bs = As + WO * W_LT;     // other rows of it; in step 3 the (64, 64) chunk of X
  float* A2 = Bs + WT * W_LT;     // the second product (dctx v^T), backward only
  float* B2 = A2 + (TWO ? WO * W_LT : 0);
  float* Ws = B2 + (TWO ? WT * W_LT : 0);
  float* Os = Ws + WO * W_LW;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int o0 = blockIdx.x * WO, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H, D = H * DH;
  const size_t rs3 = 3 * (size_t)D;
  const float* qb = p.qkv + (size_t)b * Tn * rs3 + (size_t)h * DH;
  const float* kb = qb + D;
  const float* vb = qb + 2 * D;
  const TG* gb = MODE == WIDE_FWD ? nullptr
                                  : static_cast<const TG*>(p.dctx) + (size_t)b * Tn * D +
                                        (size_t)h * DH;
  const float* kbias = p.key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const float* abh = HAS_AB ? p.ab + h * p.ab_head_stride : nullptr;
  const bool drop = p.seed != nullptr;
  uint32_t sd = 0, offset = 0;
  if (drop) {
    sd = (uint32_t)p.seed[0];
    offset = (uint32_t)p.seed[1];
  }

  for (int e = tid; e < WO * LDO; e += W_THREADS) Os[e] = 0.f;

  // per own row: its index (clamped for loads of per-row scalars; rows past
  // T are computed and dropped), and what the mode keeps per row
  int own[2];
  float own_lse[2], own_d[2], own_kb[2], own_gate[2];
  uint32_t own_key[2];
  float m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    own[i] = o0 + ty * 2 + i;
    const int t = min(own[i], Tn - 1);
    own_lse[i] = own_d[i] = own_kb[i] = 0.f;
    own_gate[i] = 1.f;
    own_key[i] = 0;
    m_run[i] = W_INIT_MAX;
    l_run[i] = 0.f;
    if (MODE == WIDE_DQ) {
      own_lse[i] = p.lse[bh + t];
      own_d[i] = p.dvec[bh + t];
    }
    if (!OWN_Q) own_kb[i] = kbias[t];
    if (MODE == WIDE_FWD && HAS_AB && p.gate != nullptr) own_gate[i] = p.gate[bh + t];
    if (drop)
      own_key[i] = OWN_Q ? sc_row_key(sd, (int64_t)bh + own[i]) : sc_col_key(offset, own[i]);
  }

  for (int t0 = 0; t0 < Tn; t0 += WT) {
    // 1. the (32, 64) product tiles, summed over the head-dim chunks
    float s[2][4] = {}, dp[2][4] = {};
    for (int c0 = 0; c0 < DH; c0 += WC) {
      __syncthreads();  // the previous chunk tiles (and step 3's X chunk) are consumed
      if (OWN_Q) {
        wide_load<WO, W_LT>(As, qb, rs3, o0, c0, Tn);
        wide_load<WT, W_LT>(Bs, kb, rs3, t0, c0, Tn);
        if (TWO) {
          wide_load<WO, W_LT>(A2, gb, (size_t)D, o0, c0, Tn);
          wide_load<WT, W_LT>(B2, vb, rs3, t0, c0, Tn);
        }
      } else {
        wide_load<WO, W_LT>(As, kb, rs3, o0, c0, Tn);
        wide_load<WT, W_LT>(Bs, qb, rs3, t0, c0, Tn);
        if (TWO) {
          wide_load<WO, W_LT>(A2, vb, rs3, o0, c0, Tn);
          wide_load<WT, W_LT>(B2, gb, (size_t)D, t0, c0, Tn);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < WC; ++d) {
        float a[2], bb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = As[(ty * 2 + i) * W_LT + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * W_LT + d];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        if (TWO) {
#pragma unroll
          for (int i = 0; i < 2; ++i) a[i] = A2[(ty * 2 + i) * W_LT + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = B2[(tx + 16 * j) * W_LT + d];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bb[j], dp[i][j]);
        }
      }
    }

    // 2. scores -> the (32, 64) weight tile, as [own][other]
    float alpha[2] = {1.f, 1.f};
    int oth[4];
    float oth_kb[4], oth_lse[4], oth_d[4];
    uint32_t oth_key[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      oth[j] = t0 + tx + 16 * j;
      const int t = min(oth[j], Tn - 1);
      oth_kb[j] = OWN_Q ? kbias[t] : 0.f;
      oth_lse[j] = oth_d[j] = 0.f;
      if (!OWN_Q) oth_lse[j] = p.lse[bh + t];
      if (MODE == WIDE_DK) oth_d[j] = p.dvec[bh + t];
      oth_key[j] = 0;
      if (drop)
        oth_key[j] = OWN_Q ? sc_col_key(offset, oth[j]) : sc_row_key(sd, (int64_t)bh + oth[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = s[i][j] + (OWN_Q ? oth_kb[j] : own_kb[i]);
        if (HAS_AB) {
          const int qi = min(OWN_Q ? own[i] : oth[j], Tn - 1);
          const int kj = min(OWN_Q ? oth[j] : own[i], Tn - 1);
          sv[j] += own_gate[i] * abh[(size_t)qi * Tn + kj];
        }
      }
      if (MODE == WIDE_FWD) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (oth[j] >= Tn) sv[j] = W_RAGGED_KEY;
        float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[i], mx);
        alpha[i] = expf(m_run[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pe = expf(sv[j] - m_new);
          ps += pe;  // the normalizer sums every weight, kept or dropped
          float pv = pe;
          if (drop) pv = sc_keep(own_key[i], oth_key[j], p.keep_thresh) ? pe * p.inv_keep : 0.f;
          Ws[(ty * 2 + i) * W_LW + tx + 16 * j] = pv;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[i] = l_run[i] * alpha[i] + ps;
        m_run[i] = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = own[i] < Tn && oth[j] < Tn;  // nothing outside T x T
          const float pr = in ? expf(sv[j] - (OWN_Q ? own_lse[i] : oth_lse[j])) : 0.f;
          float w = pr, dpv = dp[i][j];
          if (drop) {
            // the mask is keyed by (query row, key column), whichever is "own"
            const bool keep = sc_keep(OWN_Q ? own_key[i] : oth_key[j],
                                      OWN_Q ? oth_key[j] : own_key[i], p.keep_thresh);
            w = keep ? pr * p.inv_keep : 0.f;
            dpv = keep ? dpv * p.inv_keep : 0.f;
          }
          const float dd = MODE == WIDE_DQ ? own_d[i] : oth_d[j];
          Ws[(ty * 2 + i) * W_LW + tx + 16 * j] = MODE == WIDE_DV ? w : pr * (dpv - dd);
        }
      }
    }
    __syncthreads();  // the weight tile is whole; the chunk tiles are consumed

    // 3. out[own] = out[own] * alpha + W X, one 64-column chunk of X at a time
    for (int c0 = 0; c0 < DH; c0 += WC) {
      if (c0) __syncthreads();  // the previous X chunk is consumed
      if (MODE == WIDE_FWD) wide_load<WT, WC>(Bs, vb, rs3, t0, c0, Tn);
      if (MODE == WIDE_DQ) wide_load<WT, WC>(Bs, kb, rs3, t0, c0, Tn);
      if (MODE == WIDE_DK) wide_load<WT, WC>(Bs, qb, rs3, t0, c0, Tn);
      if (MODE == WIDE_DV) wide_load<WT, WC>(Bs, gb, (size_t)D, t0, c0, Tn);
      __syncthreads();
      float acc[2][4] = {};
#pragma unroll 8
      for (int kk = 0; kk < WT; ++kk) {
        float x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = Bs[kk * WC + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float w = Ws[(ty * 2 + i) * W_LW + kk];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(w, x[c], acc[i][c]);
        }
      }
      // each output element belongs to one thread for the whole kernel
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* o = &Os[(ty * 2 + i) * LDO + c0 + tx + 16 * c];
          *o = MODE == WIDE_FWD ? fmaf(*o, alpha[i], acc[i][c]) : *o + acc[i][c];
        }
    }
  }

  TG* ob = static_cast<TG*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = own[i];
    if (t >= Tn) continue;
    float f = 1.f;
    TG* row;
    if (MODE == WIDE_FWD) {
      const float l = fmaxf(l_run[i], 1e-30f);
      f = 1.f / l;
      row = ob + ((size_t)b * Tn + t) * D + (size_t)h * DH;
      if (p.lse != nullptr && tx == 0) p.lse[bh + t] = m_run[i] + logf(l);
    } else {
      if (MODE == WIDE_DQ) f = p.scale;
      row = ob + ((size_t)b * Tn + t) * rs3 + (size_t)h * DH +
            (MODE == WIDE_DQ ? 0 : MODE == WIDE_DK ? D : 2 * D);
    }
    const float* o = &Os[(ty * 2 + i) * LDO];
    for (int c = tx; c < DH; c += 16) row[c] = from_f<TG>(o[c] * f);
  }
}

template <int MODE, typename TG, int DH, bool HAS_AB>
cudaError_t launch_wide(const WideParams& p, int B, cudaStream_t stream) {
  if (B <= 0 || p.T <= 0 || p.H <= 0 || HAS_AB != (p.ab != nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes<MODE, DH>();
  cudaError_t err = cudaFuncSetAttribute(wide_attention_kernel<MODE, TG, DH, HAS_AB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + WO - 1) / WO, p.H, B);
  wide_attention_kernel<MODE, TG, DH, HAS_AB><<<grid, W_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
