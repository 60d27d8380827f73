// Fused attention block, forward (K1), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of
// speechclip_plus_tpu/nn/fused_attention_block.py:118 (launched by
// `_pallas_fwd`, :203), in both of its forward modes: out-projection fused
// (HuBERT and ViT towers) and context-only (the branch self-attention,
// reached through fused_attention_block_vjp._attn_core), each with or
// without in-kernel attention dropout (`keep_thresh`, :141-145, :183-186),
// and with the optional per-head additive bias `ab` (:169-179; a causal
// mask, WavLM's relative position bias) times the optional per-row WavLM
// gate (:173-177).
//
// What bounds it on the H100. The TPU kernel kept a whole (T, 3D) qkv row in
// VMEM (about 1.4 MB of bf16 at HuBERT shapes); an SM has 227 KB of shared
// memory, so the block is split into two kernels that one wrapper call runs:
//
//   1. gemm_*: qkv = x . Wqkv^T + bqkv with q scaled by 1/sqrt(dh) in the
//      epilogue (the TPU folded the scale into Wq on the host), and in
//      fused-out mode out = ctx . Wo^T + bo. These products are most of the
//      block's FLOPs (about 12 GFLOP per HuBERT layer at B=8, T=319), so the
//      bf16 path runs on the tensor cores (nvcuda::wmma 16x16x16, fp32
//      accumulation); the fp32 path is an FMA tile. Weights use torch's
//      (out, in) layout, so both operands are read along K with 16-byte loads.
//      Unlike the TPU kernel, a bf16 block keeps qkv in fp32: with bf16 q,
//      k and v the branch context missed its tolerance (PERF.md). The
//      context is rounded to x's dtype, as in the TPU kernel.
//   2. attention_kernel / attention_wide_kernel (attention_core.cuh, shared
//      with K4 and K5; entry point in fused_attention_block_attn.cu): grid
//      (query tile, head, batch). It reads q/k/v as
//      strided head slices of the (B, T, 3D) buffer, with no transposes (the
//      point of the TPU design), and runs an online softmax in fp32 over key
//      tiles held in shared memory, so no (T, T) score tensor reaches device
//      memory; both products of a tile run on the tensor cores (TF32 mma on
//      the fp32 tiles; see the note there). The ragged T edge is masked (no
//      padding to 16), padded query rows are computed and dropped, and masked
//      keys carry -1e30 (ragged keys -2e30), never -inf, so no NaN can
//      appear. The per-head bias is added per score tile from an fp32
//      (H | 1, T, T) tensor (4.9 MB at the WavLM shape, resident in L2),
//      scaled by gate[b, h, i]: the (B, H, T, T) gated bias never exists. The
//      TPU kernel rounded it to bf16 to fit VMEM; here it stays fp32. A head
//      of dh = 768 (the cascaded branches: one head over the model width)
//      runs the same pieces with the head dim cut across the warps
//      (attention_wide_kernel), same inputs, outputs and modes.
//
// Dropout. The keep mask of weight (b, h, i, j) is the counter hash of
// dropout_mask.cuh, seeded from a device (seed, offset) pair, so the
// backward (K2, fused_attention_block_bwd.cu) regenerates it. The online
// softmax accumulates o += (mask * e / keep) v while l sums e unmasked:
// after the final o / l this is JAX's w = p * mask / keep (:183-186). The
// context-only mode can also write the per-row log-sum-exp (B, H, T) fp32
// that K2 recomputes p from.
//
// The projection GEMMs are not pipelined (no cp.async, TMA or wgmma), and
// the fp32 qkv buffer costs twice the bytes of a bf16 one.
// Every launch reports cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "numeric.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- GEMM ----
// C[M, N] = (A[M, K] . W[N, K]^T + bias[N]) * (n < scale_cols ? scale : 1)

constexpr int GB_M = 128, GB_N = 128, GB_K = 32, G_SKEW = 8, G_THREADS = 256;

// 8 warps as 4 (M) x 2 (N); each warp owns a 32 x 64 slab = 2 x 4 fragments.
template <typename TC>
__global__ void __launch_bounds__(G_THREADS) gemm_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W,
    const float* __restrict__ bias, TC* __restrict__ C,
    int M, int N, int K, int scale_cols, float scale) {
  __shared__ __align__(128) bf16 As[GB_M][GB_K + G_SKEW];
  __shared__ __align__(128) bf16 Ws[GB_N][GB_K + G_SKEW];
  __shared__ __align__(128) float Cs[G_THREADS / 32][16][16 + 4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
    // 128 rows x 32 cols per operand = 512 chunks of 8 values; K % 8 == 0
    // (checked by the caller), so a chunk is all in or all out
    for (int c = tid; c < GB_M * GB_K / 8; c += G_THREADS) {
      const int r = c / (GB_K / 8), kc = (c % (GB_K / 8)) * 8, gk = k0 + kc;
      uint4 va = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && gk < K)
        va = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + gk);
      *reinterpret_cast<uint4*>(&As[r][kc]) = va;
      uint4 vw = make_uint4(0, 0, 0, 0);
      if (n0 + r < N && gk < K)
        vw = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + gk);
      *reinterpret_cast<uint4*>(&Ws[r][kc]) = vw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[wn * 64 + j * 16][kk], GB_K + G_SKEW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], GB_K + G_SKEW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one 16x16 fragment at a time through a per-warp scratch tile
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16 + 4, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + cc;
      if (gm < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = gn + e;
          if (n < N) {
            float v = Cs[warp][r][cc + e] + bias[n];
            if (n < scale_cols) v *= scale;
            C[(size_t)gm * N + n] = from_f<TC>(v);
          }
        }
      }
      __syncwarp();
    }
  }
}

constexpr int FB = 64, FK = 16;

// fp32 FMA tile: 256 threads, each a 4 x 4 block of the 64 x 64 output tile.
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ bias, float* __restrict__ C,
    int M, int N, int K, int scale_cols, float scale) {
  __shared__ float As[FK][FB + 4];
  __shared__ float Ws[FK][FB + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = tid; c < FB * FK; c += 256) {
      const int r = c / FK, kk = c % FK, gk = k0 + kk;
      As[kk][r] = (m0 + r < M && gk < K) ? A[(size_t)(m0 + r) * K + gk] : 0.f;
      Ws[kk][r] = (n0 + r < N && gk < K) ? W[(size_t)(n0 + r) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j] + bias[gn];
      if (gn < scale_cols) v *= scale;
      C[(size_t)gm * N + gn] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// C = (A . W^T + bias) with columns n < scale_cols multiplied by `scale`.
// A (M, K), W (N, K), C (M, N) row-major; bias (N,) fp32. ab_bf16: A and W
// bf16 on the tensor cores (K % 8 == 0), C bf16 (c_bf16) or fp32; else all
// fp32 on the FMA tile. Returns a cudaError_t.
int sc_fab_gemm(const void* a, const void* w, const float* bias, void* c,
                int M, int N, int K, int scale_cols, float scale,
                int ab_bf16, int c_bf16, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (ab_bf16) {
    if (K % 8) return (int)cudaErrorInvalidValue;
    dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
    const bf16* ab = static_cast<const bf16*>(a);
    const bf16* wb = static_cast<const bf16*>(w);
    if (c_bf16)
      gemm_bf16_kernel<bf16><<<grid, G_THREADS, 0, stream>>>(
          ab, wb, bias, static_cast<bf16*>(c), M, N, K, scale_cols, scale);
    else
      gemm_bf16_kernel<float><<<grid, G_THREADS, 0, stream>>>(
          ab, wb, bias, static_cast<float*>(c), M, N, K, scale_cols, scale);
  } else {
    if (c_bf16) return (int)cudaErrorInvalidValue;
    dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bias,
        static_cast<float*>(c), M, N, K, scale_cols, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
