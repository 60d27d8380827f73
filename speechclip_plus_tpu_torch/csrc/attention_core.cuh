// Online-softmax attention over key tiles, shared by the three attention
// kernels of the port: the fused attention block (K1, fused_attention_block.cu),
// the attention-only kernel with in-kernel dropout (K5, fused_attention.cu)
// and the flash forward with its log-sum-exp output (K4, flash.cu).
//
// One block owns 64 query rows of one (batch, head) and walks the keys in
// tiles of 64 held in shared memory, so no (T, T) score tensor reaches
// device memory and no (T, T) tile has to fit on an SM (the TPU kernels kept
// one per head in VMEM). q, k, v and the output are addressed by (batch,
// head, row) strides in elements with a contiguous head dim: the packed
// (B, T, 3D) projection buffer, (B, H, T, dh) tensors and strided views of
// either are read in place, with no transpose copy. The ragged T edge is
// masked here (nothing is padded to a tile multiple): masked keys carry the
// caller's -1e30 bias, keys past T carry -2e30, never -inf, so a fully padded
// row stays finite.
//
// Per score tile the kernel adds key_bias[b, j] and, when `ab` is given,
// gate[b, h, i] * ab[h, i, j] (ab[h, i, j] alone without a gate): the shared
// per-head bias (WavLM's relative position bias, a causal mask) is read from
// an fp32 (H | 1, T, T) tensor that stays in L2 (4.9 MB at H=12, T=320), the
// gate is one scalar per query row. The TPU kernel rounded the gated bias to
// bf16 to fit VMEM; here it stays fp32.
//
// Dropout is the counter mask of dropout_mask.cuh with
// row = (b * H + h) * T + i, so every kernel built from this header draws the
// same mask from one (seed, offset). o accumulates (mask * e / keep) v while
// l sums e unmasked: after o / l that is w = p * mask / keep.
//
// Simple first: the two products of a tile are fp32 FMAs from shared memory
// (no tensor cores), nothing is pipelined.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dropout_mask.cuh"
#include "numeric.cuh"

namespace {

constexpr int AQ = 64, AK = 64, A_THREADS = 256;
constexpr float RAGGED_KEY = -2e30f;  // below the -1e30 padding bias
constexpr float INIT_MAX = -3e38f;

// element strides of a (batch, head, row, dh) view; dh is contiguous
struct AttnStrides {
  int64_t b, h, t;
};

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  AttnStrides sq, sk, sv, so;
  const float* key_bias;    // (B, T) additive
  const float* ab;          // (H | 1, T, T) additive per-head bias, or null
  int64_t ab_head_stride;   // T * T, or 0 when one bias serves every head
  const float* gate;        // (B, H, T) factor on ab, or null
  const int64_t* seed;      // device [seed, offset], or null: no dropout
  uint32_t keep_thresh;
  float inv_keep;
  float* lse;               // (B, H, T) log-sum-exp output, or null
  float q_scale;            // applied to q as it is loaded
  int T, H;
};

template <int DH>
constexpr size_t attention_smem_bytes() {
  return sizeof(float) * (AQ * (DH + 1) + AK * (DH + 1) + AK * DH + AQ * (AK + 1));
}

// Blocks whose shared memory fits one SM (227 KB): 3 at dh = 64, 2 at dh = 96.
// The launch bounds hold the registers to that occupancy; without them the
// dh = 64 kernel takes 96 registers and two blocks per SM, and ran about a
// third slower on an H100 (PERF.md).
template <int DH>
constexpr int attention_blocks_per_sm() {
  return (int)(227 * 1024 / attention_smem_bytes<DH>());
}

// Thread (ty, tx), ty < 16, tx < 16, owns query rows ty*4 .. ty*4+3; for
// scores it owns key columns tx + 16 j (j < 4), for the output head columns
// tx + 16 c (c < DH / 16). The 16 threads of a row group are the two halves
// of one warp, so row reductions are xor-shuffles with offsets below 16.
// HAS_AB is a template parameter so that the kernel without a per-head bias
// carries none of its registers.
template <typename TI, typename TO, int DH, bool HAS_AB>
__global__ void __launch_bounds__(A_THREADS, attention_blocks_per_sm<DH>())
attention_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1, CW = DH / 16, LP = AK + 1;
  float* Qs = smem;
  float* Ks = Qs + AQ * LD;
  float* Vs = Ks + AK * LD;
  float* Ps = Vs + AK * DH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H;
  // row offsets inside one (batch, head) slice fit 32 bits (checked at launch)
  const int sqt = (int)p.sq.t, skt = (int)p.sk.t, svt = (int)p.sv.t;
  const TI* qb = static_cast<const TI*>(p.q) + b * p.sq.b + h * p.sq.h;
  const TI* kbase = static_cast<const TI*>(p.k) + b * p.sk.b + h * p.sk.h;
  const TI* vbase = static_cast<const TI*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* kb = p.key_bias + (size_t)b * Tn;

  for (int e = tid; e < AQ * DH; e += A_THREADS) {
    const int r = e / DH, c = e % DH, t = q0 + r;
    Qs[r * LD + c] = t < Tn ? to_f(qb[t * sqt + c]) * p.q_scale : 0.f;
  }

  const bool drop = p.seed != nullptr;
  uint32_t offset = 0, row_key[4];
  if (drop) {
    const uint32_t sd = (uint32_t)p.seed[0];
    offset = (uint32_t)p.seed[1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      row_key[i] = sc_row_key(sd, ((int64_t)b * H + h) * Tn + q0 + ty * 4 + i);
  }

  // per-head bias rows of this thread's queries, and their gates
  const float* ab_row[4];
  float gate[4];
  if (HAS_AB) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = min(q0 + ty * 4 + i, Tn - 1);  // rows past T are computed and dropped
      ab_row[i] = p.ab + h * p.ab_head_stride + (size_t)t * Tn;
      gate[i] = p.gate != nullptr ? p.gate[((size_t)b * H + h) * Tn + t] : 1.f;
    }
  }

  float o[4][CW];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = INIT_MAX;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += AK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < AK * DH; e += A_THREADS) {
      const int r = e / DH, c = e % DH, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < Tn) {
        kv = to_f(kbase[t * skt + c]);
        vv = to_f(vbase[t * svt + c]);
      }
      Ks[r * LD + c] = kv;
      Vs[r * DH + c] = vv;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      const float bj = t < Tn ? kb[t] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sv = s[i][j] + bj;
        if (HAS_AB && t < Tn) sv += gate[i] * ab_row[i][t];
        s[i][j] = t < Tn ? sv : RAGGED_KEY;
      }
    }

    uint32_t col_key[4];
    if (drop) {
#pragma unroll
      for (int j = 0; j < 4; ++j) col_key[j] = sc_col_key(offset, k0 + tx + 16 * j);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        ps += pe;  // the normalizer sums every weight, kept or dropped
        float pv = pe;
        if (drop) pv = sc_keep(row_key[i], col_key[j], p.keep_thresh) ? pe * p.inv_keep : 0.f;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < AK; ++kk) {
      float v[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) v[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pw = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(pw, v[c], o[i][c]);
      }
    }
  }

  TO* ob = static_cast<TO*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const float inv = 1.f / l;
    TO* out = ob + t * p.so.t;
#pragma unroll
    for (int c = 0; c < CW; ++c) out[tx + 16 * c] = from_f<TO>(o[i][c] * inv);
    if (p.lse != nullptr && tx == 0)
      p.lse[((size_t)b * H + h) * Tn + t] = m_run[i] + logf(l);
  }
}

template <typename TI, typename TO, int DH, bool HAS_AB>
cudaError_t launch_attention(const AttnParams& p, int B, cudaStream_t stream) {
  if (B <= 0 || p.T <= 0 || p.H <= 0 || HAS_AB != (p.ab != nullptr))
    return cudaErrorInvalidValue;
  const int64_t max_row = (INT32_MAX - DH) / p.T;  // the kernel's 32-bit row offsets
  if (p.sq.t < 0 || p.sk.t < 0 || p.sv.t < 0 || p.sq.t > max_row || p.sk.t > max_row ||
      p.sv.t > max_row)
    return cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<TI, TO, DH, HAS_AB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + AQ - 1) / AQ, p.H, B);
  attention_kernel<TI, TO, DH, HAS_AB><<<grid, A_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// q, k, v, o as (B, H, T, dh) tensors given by their element strides
// (strides[0..2] of q, then k, v, o), in one dtype. A template so that only
// the sources that call it instantiate its kernels.
template <typename = void>
cudaError_t launch_bhtd_attention(
    const void* q, const void* k, const void* v, void* o, const int64_t* strides,
    const float* key_bias, int B, int H, int T, int dh, int is_bf16, float q_scale,
    const int64_t* seed, uint32_t keep_thresh, float inv_keep, float* lse,
    cudaStream_t stream) {
  AttnParams p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.key_bias = key_bias;
  p.seed = seed; p.keep_thresh = keep_thresh; p.inv_keep = inv_keep;
  p.lse = lse; p.q_scale = q_scale; p.T = T; p.H = H;
  if (dh == 64)
    return is_bf16 ? launch_attention<bf16, bf16, 64, false>(p, B, stream)
                   : launch_attention<float, float, 64, false>(p, B, stream);
  if (dh == 96)
    return is_bf16 ? launch_attention<bf16, bf16, 96, false>(p, B, stream)
                   : launch_attention<float, float, 96, false>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
