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
// the per-row log-sum-exp K1 wrote, tile by tile:
//   1. bwd_dvec_kernel: D (B, H, T) fp32.
//   2. bwd_dkdv_kernel: grid (key tile, head, batch); one pass over the query
//      tiles accumulates dk and dv in registers.
//   3. bwd_dq_kernel: grid (query tile, head, batch); one pass over the key
//      tiles accumulates dq.
// Each output element is summed by one thread in a fixed order: no float
// atomics, so repeated runs are bit-identical. Simple first: the products
// are fp32 FMAs from shared memory (q, k and v are fp32 in K1's buffer), as
// in K1's attention kernel; tensor cores and pipelining are later work.
// A head of dh = 768 (the cascaded branches) does not fit these tiles (four
// (64, 769) fp32 tiles are 787 KB); it runs the chunked kernels of
// attention_wide.cuh behind the same entry point.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_wide.cuh"
#include "dropout_mask.cuh"
#include "numeric.cuh"

namespace {

constexpr int BT = 64, B_THREADS = 256;  // 64 x 64 (query, key) tiles
constexpr int LS = BT + 1;               // row stride of the (64, 64) tiles

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * BT * (DH + 1) + 2 * BT * LS + 2 * BT);
}
template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * BT * (DH + 1) + BT * LS + 2 * BT);
}

// rows [r0, r0 + 64) x head columns of one (b, h) slice of a (B, T, W)
// buffer into a (64, DH + 1) fp32 tile, zero past Tn
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base, size_t row_stride,
                                          int r0, int Tn) {
  for (int e = threadIdx.x; e < BT * DH; e += B_THREADS) {
    const int r = e / DH, c = e % DH, t = r0 + r;
    dst[r * (DH + 1) + c] = t < Tn ? to_f(base[(size_t)t * row_stride + c]) : 0.f;
  }
}

// The (64 x 64) score and dctx v^T blocks of one (query tile, key tile)
// pair, then p, the dropped-and-scaled weights and ds. Thread (ty, tx) owns
// queries ty*4 + i and keys tx + 16 j. Writes ds (and w when `ws` is not
// null) into shared memory as [query][key].
template <int DH>
__device__ __forceinline__ void score_grad_tile(
    const float* Qs, const float* Gs, const float* Ks, const float* Vs,
    const float* lse_s, const float* d_s, const float* __restrict__ kb,
    const float* __restrict__ abh, int q0, int k0, int Tn, bool drop, const uint32_t row_key[4],
    const uint32_t col_key[4], uint32_t thresh, float inv_keep, float* ws,
    float* dss) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * LD + d];
      g[i] = Gs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kt = k0 + tx + 16 * j;
    const float bj = kt < Tn ? kb[kt] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
      // p from the forward's log-sum-exp; nothing outside T x T
      const bool in = kt < Tn && q0 + qr < Tn;
      const float sb = (abh != nullptr && in) ? bj + abh[(size_t)(q0 + qr) * Tn + kt] : bj;
      const float p = in ? expf(s[i][j] + sb - lse_s[qr]) : 0.f;
      float w = p, dpv = dp[i][j];
      if (drop) {
        const bool keep = sc_keep(row_key[i], col_key[j], thresh);
        w = keep ? p * inv_keep : 0.f;
        dpv = keep ? dpv * inv_keep : 0.f;
      }
      if (ws != nullptr) ws[qr * LS + tx + 16 * j] = w;
      dss[qr * LS + tx + 16 * j] = p * (dpv - d_s[qr]);
    }
  }
}

__device__ __forceinline__ void mask_keys(const int64_t* seed, int b, int h, int H, int Tn,
                                          int q0, int k0, uint32_t row_key[4],
                                          uint32_t col_key[4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t sd = (uint32_t)seed[0], offset = (uint32_t)seed[1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_key[i] = sc_row_key(sd, ((int64_t)b * H + h) * Tn + q0 + ty * 4 + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) col_key[j] = sc_col_key(offset, k0 + tx + 16 * j);
}

// D[b, h, t] = sum_c dctx[b, t, h*DH + c] * ctx[b, t, h*DH + c]
template <typename TG>
__global__ void bwd_dvec_kernel(const TG* __restrict__ dctx, const TG* __restrict__ ctx,
                                float* __restrict__ dvec, int B, int Tn, int H, int DH) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // (b, t, h)
  if (idx >= B * Tn * H) return;
  const int h = idx % H, bt = idx / H, t = bt % Tn, b = bt / Tn;
  const size_t o = (size_t)bt * H * DH + (size_t)h * DH;
  float acc = 0.f;
  for (int c = 0; c < DH; ++c) acc = fmaf(to_f(dctx[o + c]), to_f(ctx[o + c]), acc);
  dvec[((size_t)b * H + h) * Tn + t] = acc;
}

template <typename TG, int DH>
__global__ void __launch_bounds__(B_THREADS) bwd_dkdv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ key_bias,
    const float* __restrict__ ab, int64_t ab_head_stride,
    const TG* __restrict__ dctx, const float* __restrict__ lse,
    const float* __restrict__ dvec, const int64_t* __restrict__ seed,
    uint32_t thresh, float inv_keep, TG* __restrict__ dqkv, int Tn, int H) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1, CW = DH / 16;
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* Gs = Qs + BT * LD;
  float* Ws = Gs + BT * LD;
  float* Ds = Ws + BT * LS;
  float* lse_s = Ds + BT * LS;
  float* d_s = lse_s + BT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t rs3 = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * Tn * rs3 + (size_t)h * DH;
  const TG* gbase = dctx + (size_t)b * Tn * D + (size_t)h * DH;
  const float* kb = key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const bool drop = seed != nullptr;
  const float* abh = ab != nullptr ? ab + h * ab_head_stride : nullptr;

  load_tile<DH>(Ks, base + D, rs3, k0, Tn);
  load_tile<DH>(Vs, base + 2 * D, rs3, k0, Tn);
  float dk[4][CW], dv[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < Tn; q0 += BT) {
    __syncthreads();  // the previous tile's Q, dctx, w and ds are consumed
    load_tile<DH>(Qs, base, rs3, q0, Tn);
    load_tile<DH>(Gs, gbase, D, q0, Tn);
    for (int r = tid; r < BT; r += B_THREADS) {
      const bool in = q0 + r < Tn;
      lse_s[r] = in ? lse[bh + q0 + r] : 0.f;
      d_s[r] = in ? dvec[bh + q0 + r] : 0.f;
    }
    __syncthreads();
    uint32_t row_key[4] = {}, col_key[4] = {};
    if (drop) mask_keys(seed, b, h, H, Tn, q0, k0, row_key, col_key);
    score_grad_tile<DH>(Qs, Gs, Ks, Vs, lse_s, d_s, kb, abh, q0, k0, Tn, drop, row_key,
                        col_key, thresh, inv_keep, Ws, Ds);
    __syncthreads();
    // dv[k] += sum_q w[q][k] dctx[q];  dk[k] += sum_q ds[q][k] q[q]
    // (thread owns keys ty*4 + i and head columns tx + 16 c)
#pragma unroll 4
    for (int q = 0; q < BT; ++q) {
      float g[CW], a[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        g[c] = Gs[q * LD + tx + 16 * c];
        a[c] = Qs[q * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = Ws[q * LS + ty * 4 + i], ds = Ds[q * LS + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dv[i][c] = fmaf(w, g[c], dv[i][c]);
          dk[i][c] = fmaf(ds, a[c], dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= Tn) continue;
    TG* row = dqkv + ((size_t)b * Tn + t) * rs3 + (size_t)h * DH;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      row[D + tx + 16 * c] = from_f<TG>(dk[i][c]);
      row[2 * D + tx + 16 * c] = from_f<TG>(dv[i][c]);
    }
  }
}

template <typename TG, int DH>
__global__ void __launch_bounds__(B_THREADS) bwd_dq_kernel(
    const float* __restrict__ qkv, const float* __restrict__ key_bias,
    const float* __restrict__ ab, int64_t ab_head_stride,
    const TG* __restrict__ dctx, const float* __restrict__ lse,
    const float* __restrict__ dvec, const int64_t* __restrict__ seed,
    uint32_t thresh, float inv_keep, float scale, TG* __restrict__ dqkv, int Tn, int H) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1, CW = DH / 16;
  float* Qs = smem;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ds = Vs + BT * LD;
  float* lse_s = Ds + BT * LS;
  float* d_s = lse_s + BT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t rs3 = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * Tn * rs3 + (size_t)h * DH;
  const TG* gbase = dctx + (size_t)b * Tn * D + (size_t)h * DH;
  const float* kb = key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const bool drop = seed != nullptr;
  const float* abh = ab != nullptr ? ab + h * ab_head_stride : nullptr;

  load_tile<DH>(Qs, base, rs3, q0, Tn);
  load_tile<DH>(Gs, gbase, D, q0, Tn);
  for (int r = tid; r < BT; r += B_THREADS) {
    const bool in = q0 + r < Tn;
    lse_s[r] = in ? lse[bh + q0 + r] : 0.f;
    d_s[r] = in ? dvec[bh + q0 + r] : 0.f;
  }
  float dq[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dq[i][c] = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += BT) {
    __syncthreads();  // the previous tile's K, V and ds are consumed
    load_tile<DH>(Ks, base + D, rs3, k0, Tn);
    load_tile<DH>(Vs, base + 2 * D, rs3, k0, Tn);
    __syncthreads();
    uint32_t row_key[4] = {}, col_key[4] = {};
    if (drop) mask_keys(seed, b, h, H, Tn, q0, k0, row_key, col_key);
    score_grad_tile<DH>(Qs, Gs, Ks, Vs, lse_s, d_s, kb, abh, q0, k0, Tn, drop, row_key,
                        col_key, thresh, inv_keep, nullptr, Ds);
    __syncthreads();
    // dq[q] += sum_k ds[q][k] k[k]  (thread owns queries ty*4 + i)
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float kv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ds[(ty * 4 + i) * LS + kk];
#pragma unroll
        for (int c = 0; c < CW; ++c) dq[i][c] = fmaf(ds, kv[c], dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
    TG* row = dqkv + ((size_t)b * Tn + t) * rs3 + (size_t)h * DH;
#pragma unroll
    for (int c = 0; c < CW; ++c) row[tx + 16 * c] = from_f<TG>(dq[i][c] * scale);
  }
}

template <typename TG, int DH>
cudaError_t launch_bwd(const float* qkv, const float* key_bias, const float* ab,
                       int64_t ab_head_stride, const void* dctx,
                       const void* ctx, const float* lse, float* dvec, const int64_t* seed,
                       uint32_t thresh, float inv_keep, float scale, void* dqkv, int B,
                       int Tn, int H, cudaStream_t stream) {
  const TG* g = static_cast<const TG*>(dctx);
  TG* out = static_cast<TG*>(dqkv);
  const int rows = B * Tn * H;
  bwd_dvec_kernel<TG><<<(rows + 255) / 256, 256, 0, stream>>>(
      g, static_cast<const TG*>(ctx), dvec, B, Tn, H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t s1 = dkdv_smem_bytes<DH>(), s2 = dq_smem_bytes<DH>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<TG, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<TG, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, H, B);
  bwd_dkdv_kernel<TG, DH><<<grid, B_THREADS, s1, stream>>>(
      qkv, key_bias, ab, ab_head_stride, g, lse, dvec, seed, thresh, inv_keep, out, Tn, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<TG, DH><<<grid, B_THREADS, s2, stream>>>(
      qkv, key_bias, ab, ab_head_stride, g, lse, dvec, seed, thresh, inv_keep, scale, out, Tn,
      H);
  return cudaGetLastError();
}

// dh = 768: D, then dq, dk and dv, each one launch of the chunked kernel
template <typename TG, bool HAS_AB>
cudaError_t launch_bwd_wide(const WideParams& p, const void* ctx, float* dvec, int B,
                            cudaStream_t stream) {
  constexpr int DH = 768;
  const int rows = B * p.T * p.H;
  bwd_dvec_kernel<TG><<<(rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const TG*>(p.dctx), static_cast<const TG*>(ctx), dvec, B, p.T, p.H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_wide<WIDE_DQ, TG, DH, HAS_AB>(p, B, stream);
  if (err != cudaSuccess) return err;
  err = launch_wide<WIDE_DK, TG, DH, HAS_AB>(p, B, stream);
  if (err != cudaSuccess) return err;
  return launch_wide<WIDE_DV, TG, DH, HAS_AB>(p, B, stream);
}

}  // namespace

extern "C" {

// dqkv (B, T, 3*H*dh) from the packed fp32 qkv (q scaled by `scale`), the
// key bias (B, T) fp32, the optional per-head bias `ab` (ab_heads, T, T) fp32
// with ab_heads 1 or H (null for none), the context cotangent dctx and the
// context ctx (B, T, H*dh; bf16 when g_bf16, else fp32, as is dqkv), K1's log-sum-exp
// lse (B, H, T) fp32, and the dropout seed (device int64 [seed, offset], or
// null for none) with its threshold and 1/keep. Scratch: dvec (B, H, T)
// fp32. dq is returned times `scale`. Returns a cudaError_t.
int sc_fab_attention_bwd(const float* qkv, const float* key_bias, const float* ab,
                         int ab_heads, const void* dctx,
                         const void* ctx, const float* lse, float* dvec,
                         const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                         float scale, void* dqkv, int B, int Tn, int H, int dh,
                         int g_bf16, cudaStream_t stream) {
  if (B <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (ab != nullptr && ab_heads != 1 && ab_heads != H) return (int)cudaErrorInvalidValue;
  const int64_t ab_stride = ab_heads == 1 ? 0 : (int64_t)Tn * Tn;
  cudaError_t err;
  if (dh == 768) {
    WideParams p = {};
    p.qkv = qkv;
    p.key_bias = key_bias;
    p.ab = ab;
    p.ab_head_stride = ab_stride;
    p.seed = seed;
    p.keep_thresh = keep_thresh;
    p.inv_keep = inv_keep;
    p.lse = const_cast<float*>(lse);
    p.dctx = dctx;
    p.dvec = dvec;
    p.out = dqkv;
    p.scale = scale;
    p.T = Tn;
    p.H = H;
    if (ab != nullptr)
      err = g_bf16 ? launch_bwd_wide<bf16, true>(p, ctx, dvec, B, stream)
                   : launch_bwd_wide<float, true>(p, ctx, dvec, B, stream);
    else
      err = g_bf16 ? launch_bwd_wide<bf16, false>(p, ctx, dvec, B, stream)
                   : launch_bwd_wide<float, false>(p, ctx, dvec, B, stream);
    return (int)err;
  }
#define SC_BWD(TG, DHV)                                                            \
  launch_bwd<TG, DHV>(qkv, key_bias, ab, ab_stride, dctx, ctx, lse, dvec, seed,    \
                      keep_thresh, inv_keep, scale, dqkv, B, Tn, H, stream)
  if (dh == 64)
    err = g_bf16 ? SC_BWD(bf16, 64) : SC_BWD(float, 64);
  else if (dh == 96)
    err = g_bf16 ? SC_BWD(bf16, 96) : SC_BWD(float, 96);
  else
    err = cudaErrorInvalidValue;
#undef SC_BWD
  return (int)err;
}

}  // extern "C"
