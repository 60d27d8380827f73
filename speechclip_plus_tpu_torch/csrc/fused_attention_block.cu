// Fused attention block, forward (K1), for Hopper (sm_90a): the projection
// GEMMs (K1a) and the block's C entry points.
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
// memory, so the block is split into kernels that one wrapper call runs:
//
//   1. K1a, the projections (this file, `projection` in
//      nn/fused_attention_block.py): qkv = x . Wqkv^T + bqkv with q scaled
//      by 1/sqrt(dh) in the epilogue (the TPU folded the scale into Wq on the
//      host, :522-527), and in fused-out mode out = ctx . Wo^T + bo (the TPU
//      kernel's two products, :153-157 and :193-198). Most of the block's
//      FLOPs (12 GFLOP per HuBERT layer at B=8, T=319), so at bf16 they are
//      bound by the tensor cores, except that the qkv buffer is fp32 (with
//      bf16 q, k and v the branch context missed its tolerance: PERF.md):
//      its 377 MB write at B=128 is 0.11 of the 0.15 ms bound.
//      `projection_wgmma_kernel`: 128 x 128 output tiles, K in steps of 64.
//      One producer warp keeps a ring of 3 stages of A and W tiles (both
//      K-major, torch's (out, in) weight layout) in flight by TMA, 128-byte
//      swizzled, each stage's arrival counted in bytes on an mbarrier; two
//      consumer warpgroups (64 rows each) multiply with wgmma m64n128k16
//      (bf16 operands from shared memory, fp32 accumulators in registers),
//      keep one k-step's products in flight and hand a stage back to the
//      producer when its products are done. Two blocks share an SM (96 KB
//      of ring each), so one block's epilogue (bias, scale, 8-byte stores of
//      fp32 or 4-byte stores of bf16 pairs, rows past M masked: TMA fills
//      them with zeros) runs under the other's products. Each output is
//      summed over K by one accumulator in a fixed order (no split-K):
//      reruns are bit-identical. The fp32 mode is an FMA tile
//      (`gemm_f32_kernel`).
//   2. K1b, the attention kernel (attention_core.cuh, shared with K4 and K5;
//      entry point in fused_attention_block_attn.cu): grid (query tile, head,
//      batch). It reads q/k/v as strided head slices of the (B, T, 3D)
//      buffer, with no transposes (the point of the TPU design), and runs an
//      online softmax in fp32 over key tiles held in shared memory, so no
//      (T, T) score tensor reaches device memory; both products of a tile run
//      on the tensor cores (TF32 mma; see the note there). The ragged T edge
//      is masked, masked keys carry -1e30 (ragged keys -2e30), never -inf. The
//      per-head bias is added per score tile from an fp32 (H | 1, T, T) tensor
//      scaled by gate[b, h, i]: the (B, H, T, T) gated bias never exists. A
//      head of dh = 768 or 1024 (the cascaded branches, base and large) cuts
//      the head dim across the warps of a block (`attention_wide_kernel`
//      there).
//
// Dropout. The keep mask of weight (b, h, i, j) is the counter hash of
// dropout_mask.cuh, seeded from a device (seed, offset) pair, so the
// backward (K2, fused_attention_block_bwd.cu) regenerates it. The
// context-only mode can also write the per-row log-sum-exp (B, H, T) fp32
// that K2 recomputes p from.
//
// Every launch reports cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "numeric.cuh"

namespace {

// ----------------------------------------------------------- K1a, bf16 ----
// C[M, N] = (A[M, K] . W[N, K]^T + bias[N]) * (n < scale_cols ? scale : 1)

constexpr int PM = 128, PN = 128, PK = 64, P_STAGES = 3;
constexpr int P_CONSUMERS = 256, P_THREADS = P_CONSUMERS + 32;  // two warpgroups + a producer warp
constexpr uint32_t P_TILE_A = PM * PK * 2, P_TILE_W = PN * PK * 2, P_STAGE = P_TILE_A + P_TILE_W;
// the ring, 1 KB to align it to the swizzle's 1024 bytes, and 2 barriers a stage
constexpr size_t P_SMEM = P_STAGES * P_STAGE + 1024 + 2 * P_STAGES * 8;

template <typename TC, typename TB>
__global__ void __launch_bounds__(P_THREADS, 2) projection_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const TB* __restrict__ bias, TC* __restrict__ C, int M, int N, int K, int scale_cols,
    float scale) {
  extern __shared__ uint8_t p_smem[];
  const uint32_t ring = (smem_u32(p_smem) + 1023) & ~1023u;
  const uint32_t full = ring + P_STAGES * P_STAGE;  // stage s: full + 8 s; empty + 8 s
  const uint32_t empty = full + 8 * P_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * PN, m0 = blockIdx.y * PM;
  const int nk = (K + PK - 1) / PK;  // TMA fills K past its end with zeros
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                      // the producer's expect_tx
      mbar_init(empty + 8 * s, P_CONSUMERS / 32);      // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == P_CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % P_STAGES;
        const uint32_t round = (uint32_t)(kb / P_STAGES) & 1u;
        mbar_wait(empty + 8 * s, round ^ 1u);  // the first round passes at once
        const uint32_t a = ring + s * P_STAGE;
        mbar_expect_tx(full + 8 * s, P_STAGE);
        tma_load_2d(a, &map_a, full + 8 * s, kb * PK, m0);
        tma_load_2d(a + P_TILE_A, &map_w, full + 8 * s, kb * PK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;  // rows 64 wg .. 64 wg + 63 of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % P_STAGES;
    mbar_wait(full + 8 * s, (uint32_t)(kb / P_STAGES) & 1u);
    const uint32_t a = ring + s * P_STAGE;
    const uint64_t da = sw128_desc(a + wg * 64 * 128), dw = sw128_desc(a + P_TILE_A);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < PK / 16; ++k) wgmma_m64n128k16(acc, da + 2 * k, dw + 2 * k);  // +32 bytes
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-step's products are done: its stage goes back
    if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % P_STAGES));
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);

  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < PN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);  // N is even: col < N covers col + 1
    if (col >= N) continue;
    const float b0 = to_f(bias[col]), b1 = to_f(bias[col + 1]);
    const float f0 = col < scale_cols ? scale : 1.f, f1 = col + 1 < scale_cols ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= M) continue;
      const float v0 = (acc[4 * j + 2 * i] + b0) * f0, v1 = (acc[4 * j + 2 * i + 1] + b1) * f1;
      TC* dst = C + (size_t)row * N + col;
      if constexpr (sizeof(TC) == 4)
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// it is fetched through the runtime's entry-point query
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// a (rows, cols) row-major bf16 matrix as boxes of (box_rows, 64), 128-byte swizzled
bool bf16_tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)PK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TC, typename TB>
cudaError_t launch_projection(const bf16* a, const bf16* w, const TB* bias, TC* c, int M, int N,
                              int K, int scale_cols, float scale, cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  if (!bf16_tile_map(&map_a, a, M, K, PM) || !bf16_tile_map(&map_w, w, N, K, PN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(projection_wgmma_kernel<TC, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + PN - 1) / PN, (M + PM - 1) / PM);  // neighbours share an A tile
  projection_wgmma_kernel<TC, TB><<<grid, P_THREADS, P_SMEM, stream>>>(map_a, map_w, bias, c, M, N,
                                                                      K, scale_cols, scale);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t launch_projection(const bf16* a, const bf16* w, const void* bias, int bias_bf16,
                              TC* c, int M, int N, int K, int scale_cols, float scale,
                              cudaStream_t stream) {
  if (bias_bf16)
    return launch_projection(a, w, static_cast<const bf16*>(bias), c, M, N, K, scale_cols, scale,
                             stream);
  return launch_projection(a, w, static_cast<const float*>(bias), c, M, N, K, scale_cols, scale,
                           stream);
}

// ----------------------------------------------------------- K1a, fp32 ----

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
// A (M, K), W (N, K), C (M, N) row-major; bias (N,) fp32, or bf16 with A and
// W bf16 (bias_bf16). ab_bf16: A and W bf16 (16-byte aligned, K % 8 == 0:
// TMA's row stride) on the wgmma kernel, C bf16 (c_bf16) or fp32 (N even);
// else all fp32 on the FMA tile. Returns a cudaError_t.
int sc_fab_gemm(const void* a, const void* w, const void* bias, void* c,
                int M, int N, int K, int scale_cols, float scale,
                int ab_bf16, int c_bf16, int bias_bf16, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (ab_bf16) {
    if (K % 8 || N % 2 || reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
      return (int)cudaErrorInvalidValue;
    const bf16* ab = static_cast<const bf16*>(a);
    const bf16* wb = static_cast<const bf16*>(w);
    if (c_bf16)
      return (int)launch_projection(ab, wb, bias, bias_bf16, static_cast<bf16*>(c), M, N, K,
                                    scale_cols, scale, stream);
    return (int)launch_projection(ab, wb, bias, bias_bf16, static_cast<float*>(c), M, N, K,
                                  scale_cols, scale, stream);
  }
  if (c_bf16 || bias_bf16) return (int)cudaErrorInvalidValue;
  dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
  gemm_f32_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(c), M, N, K, scale_cols, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
