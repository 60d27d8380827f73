// Waveform convolution, the acoustic frontend's layer 0 (K6), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `_conv0_kernel` of
// speechclip_plus_tpu/ops/conv_frontend.py:45 (launched by `conv0_pallas`,
// :64): out[b, f, c] = sum_{j < k} wav[b, s f + j] * K[j, 0, c], VALID, fp32
// accumulation, (B, T) x (k, 1, C) -> (B, T0, C), T0 = (T - k) / s + 1.
//
// What bounds it on the H100. At B=128, T=102400, C=512, k=10, s=5 it reads
// 26 MB of waveform and writes 128 x 20479 x 512 outputs (2.7 GB in bf16,
// 5.4 GB in fp32) for 26.8 GFLOP: it is bound by the output write. The TPU
// kernel deinterleaved the waveform by tap residue on the host so that the
// taps became two matrix products for the MXU; here the contraction is 10
// wide, so tensor cores would idle, and what matters is that each output
// byte is written once, coalesced. A block owns 128 frames of one utterance:
// it stages the waveform strip (s * 127 + k samples) and the taps (k x C) in
// shared memory as fp32; a thread owns two neighbouring channels and eight
// frames at a time (per tap: one float2 of taps, eight broadcast samples, 16
// FMAs) and stores channel pairs, so a warp writes 128 (bf16) or 256 (fp32)
// contiguous bytes per frame. Any k and s (s <= k is not required); C even.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int C_FRAMES = 128, C_FR = 8, C_THREADS = 256;

// grid (frame tile, batch). Shared memory: taps (k, C) fp32, then the strip.
template <typename TI, typename TO>
__global__ void __launch_bounds__(C_THREADS) conv0_kernel(
    const TI* __restrict__ wav, const TI* __restrict__ taps, TO* __restrict__ out,
    int T, int T0, int C, int k, int s) {
  extern __shared__ float smem[];
  float* Ks = smem;           // [j * C + c]
  float* Ws = smem + k * C;   // the strip of this tile
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * C_FRAMES, b = blockIdx.y;
  const int nf = min(C_FRAMES, T0 - f0);
  const int strip = s * (nf - 1) + k;
  const TI* w = wav + (size_t)b * T + (size_t)f0 * s;
  for (int e = tid; e < k * C; e += C_THREADS) Ks[e] = to_f(taps[e]);
  for (int e = tid; e < strip; e += C_THREADS) Ws[e] = to_f(w[e]);
  __syncthreads();

  TO* ob = out + ((size_t)b * T0 + f0) * C;
  for (int c = 2 * tid; c < C; c += 2 * C_THREADS) {
    for (int fb = 0; fb < nf; fb += C_FR) {
      float a0[C_FR] = {}, a1[C_FR] = {};
      for (int j = 0; j < k; ++j) {
        const float2 kk = *reinterpret_cast<const float2*>(&Ks[j * C + c]);
#pragma unroll
        for (int r = 0; r < C_FR; ++r) {
          // frames past the tile's end read inside the strip's last frame
          const float x = Ws[min(fb + r, nf - 1) * s + j];
          a0[r] = fmaf(x, kk.x, a0[r]);
          a1[r] = fmaf(x, kk.y, a1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < C_FR; ++r)
        if (fb + r < nf) store2(ob + (size_t)(fb + r) * C + c, a0[r], a1[r]);
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch_conv0(const void* wav, const void* taps, void* out, int B, int T,
                         int T0, int C, int k, int s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)k * C + (size_t)s * (C_FRAMES - 1) + k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv0_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T0 + C_FRAMES - 1) / C_FRAMES, B);
  conv0_kernel<TI, TO><<<grid, C_THREADS, smem, stream>>>(
      static_cast<const TI*>(wav), static_cast<const TI*>(taps), static_cast<TO*>(out),
      T, T0, C, k, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wav (B, T) and taps (k, C) contiguous in one dtype (fp32, or bf16 when
// in_bf16); out (B, T0, C) contiguous, fp32 or bf16 (out_bf16), T0 =
// (T - k) / s + 1 >= 1. C must be even (channel pairs are stored together).
// Returns a cudaError_t.
int sc_conv0(const void* wav, const void* taps, void* out, int B, int T, int C, int k,
             int s, int in_bf16, int out_bf16, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || C % 2 || k <= 0 || s <= 0 || T < k || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int T0 = (T - k) / s + 1;
  cudaError_t err;
  if (in_bf16)
    err = out_bf16 ? launch_conv0<bf16, bf16>(wav, taps, out, B, T, T0, C, k, s, stream)
                   : launch_conv0<bf16, float>(wav, taps, out, B, T, T0, C, k, s, stream);
  else
    err = out_bf16 ? launch_conv0<float, bf16>(wav, taps, out, B, T, T0, C, k, s, stream)
                   : launch_conv0<float, float>(wav, taps, out, B, T, T0, C, k, s, stream);
  return (int)err;
}

}  // extern "C"
