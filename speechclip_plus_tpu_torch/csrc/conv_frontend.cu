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
//
// Layer 0 of a group-norm frontend, fused (conv0_gn_gelu): conv 0 ->
// GroupNorm(C, C) with fp32 statistics over every frame -> exact-erf GELU,
// (B, T) -> (B, C, T0) channel-first in the waveform's dtype. It replaces no
// TPU kernel: it replaces the port's composite (F.conv1d, then an fp32 copy
// of the output and a dozen elementwise passes over it; the twin
// `plain_conv0_gn_gelu`), and reuses K6's staging of the waveform strip. At
// B=256, T=102400, C=512 the output is 5.37 GB in bf16 and the composite
// moved about 150 GB; the least work is reading 52 MB of waveform and
// writing the output once (1.6 ms at 3.35 TB/s), plus 26.8 G multiply-adds a
// pass of conv 0 (0.8 ms on the CUDA cores). So the raw conv output is never
// stored: conv 0 is recomputed from the waveform (1/100 of the output's
// bytes) in two passes, each bound by its instructions. (1)
// conv0_gn_stats_kernel: a block owns 256 frames of one utterance and every
// channel, a thread a channel pair with its taps in registers; it computes
// conv 0 in fp32 in tap order (at k=10, s=5 the 45 samples of 8 frames are
// read as broadcast float4s), rounds each value to the dtype (as the library
// convolution's output is rounded) and writes each channel's tile mean and M2
// (sums of differences from the tile's first value); conv0_gn_merge_kernel
// merges one (utterance, channel)'s tiles in tile order by Chan's formula
// into mean and rstd, so reruns are bit-identical. (2)
// conv0_gn_apply_kernel: a block owns 1024 frames of 64 channels; it
// recomputes the same rounded values, applies (x - mean) * rstd * gamma +
// beta in fp32, rounds, applies GELU in fp32, rounds, and stages a kilobyte
// of frames per channel in shared memory, which each warp stores as whole
// rows (a row starts anywhere: T0 is odd). With 128-byte runs strewn over
// every channel this kernel took 8.3 ms on the H100 at B=256, with kilobyte
// runs 5.7. In bf16 GELU reads a table of the formula's own bits for |y| in
// [2^-16, 16), built by the merge kernel, and takes the formula elsewhere:
// erff took 2.2 of those 5.7 ms. Three launches, no host sync, no
// activation-sized scratch.
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


// ---- conv0_gn_gelu: layer 0 of a group-norm frontend, fused ----

// G_TILE frames a statistics block covers; an apply block covers G_ATILE
// frames of G_ACH channels, staging G_AROW bytes of frames a channel at a time
constexpr int G_THREADS = 256, G_FR = 8, G_KMAX = 10, G_TILE = 256;
constexpr int G_ATILE = 1024, G_ACH = 64, G_AROW = 1024;
// bf16 GELU by table: the bf16 values y with |y| in [2^-16, 2^4) (biased
// exponents 111..130, both signs), each entry the bf16 bits of g_gelu(y)
constexpr int G_LUT_LO = 111 << 7, G_LUT_N = 20 << 7;

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// samples of the strip `frames` frames need (zero past the waveform), padded
// for the float4 reads of their last 8 frames
__host__ __device__ inline int g_strip(int k, int s, int frames) {
  const int full = s * (frames - 1) + k;
  const int vec = s * (frames - G_FR) + 4 * ((s * (G_FR - 1) + k + 3) / 4);
  return ((full > vec ? full : vec) + 3) / 4 * 4;
}

// the strip of frames [f0, f0 + frames) of utterance b into shared memory, fp32
template <typename T>
__device__ __forceinline__ void g_load_strip(float* Ws, const T* wav, int b, int T_, int f0,
                                             int k, int s, int frames) {
  const T* w = wav + (size_t)b * T_;
  const int n = g_strip(k, s, frames), start = f0 * s;
  for (int e = threadIdx.x; e < n; e += G_THREADS)
    Ws[e] = start + e < T_ ? to_f(w[start + e]) : 0.f;
}

// conv 0 at frames [fb, fb + 8) of the tile for channels c, c + 1: fp32 sums in
// tap order, each rounded to T. K = S = 0: k <= G_KMAX and s at run time.
template <typename T, int K, int S>
__device__ __forceinline__ void g_conv8(const float* Ws, const float2 (&tk)[G_KMAX], int k, int s,
                                        int fb, float (&a0)[G_FR], float (&a1)[G_FR]) {
#pragma unroll
  for (int r = 0; r < G_FR; ++r) a0[r] = a1[r] = 0.f;
  if constexpr (K > 0) {
    constexpr int NV = (S * (G_FR - 1) + K + 3) / 4;
    float w[4 * NV];
    const float4* src = reinterpret_cast<const float4*>(Ws + S * fb);  // S * fb % 4 == 0
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 q = src[v];
      w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int r = 0; r < G_FR; ++r) {
        a0[r] = fmaf(w[r * S + j], tk[j].x, a0[r]);
        a1[r] = fmaf(w[r * S + j], tk[j].y, a1[r]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < G_KMAX; ++j) {
      if (j >= k) break;
#pragma unroll
      for (int r = 0; r < G_FR; ++r) {
        const float x = Ws[(fb + r) * s + j];
        a0[r] = fmaf(x, tk[j].x, a0[r]);
        a1[r] = fmaf(x, tk[j].y, a1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < G_FR; ++r) {
    a0[r] = round_to<T>(a0[r]);
    a1[r] = round_to<T>(a1[r]);
  }
}

template <typename T>
__device__ __forceinline__ void g_load_taps(float2 (&tk)[G_KMAX], const T* taps, int k, int C,
                                            int c) {
#pragma unroll
  for (int j = 0; j < G_KMAX; ++j)
    tk[j] = j < k ? make_float2(to_f(taps[j * C + c]), to_f(taps[j * C + c + 1]))
                  : make_float2(0.f, 0.f);
}

// Chan's merge of (n, mean, M2) with a part of nb values, mean mb and M2 qb
__device__ __forceinline__ void g_chan(float& n, float& m, float& q, float nb, float mb,
                                       float qb) {
  const float nn = n + nb, d = mb - m, wb = nb / nn;
  m = fmaf(d, wb, m);
  q = q + qb + d * d * n * wb;
  n = nn;
}

// grid (tiles, B): each channel's mean and M2 over the tile's frames
template <typename T, int K, int S>
__global__ void __launch_bounds__(G_THREADS, 2) conv0_gn_stats_kernel(
    const T* __restrict__ wav, const T* __restrict__ taps, float* __restrict__ pmean,
    float* __restrict__ pm2, int T_, int T0, int C, int k, int s) {
  extern __shared__ float4 g_smem4[];
  float* Ws = reinterpret_cast<float*>(g_smem4);
  const int tile = blockIdx.x, b = blockIdx.y, f0 = tile * G_TILE;
  const int nf = min(G_TILE, T0 - f0);
  g_load_strip(Ws, wav, b, T_, f0, K ? K : k, S ? S : s, G_TILE);
  __syncthreads();
  const size_t row = ((size_t)b * gridDim.x + tile) * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * G_THREADS) {
    float2 tk[G_KMAX];
    g_load_taps(tk, taps, K ? K : k, C, c);
    // sums of the differences from the tile's first value (close to the
    // tile's mean against the spread, so the tile's M2 keeps its digits)
    float h0 = 0.f, h1 = 0.f, s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    for (int fb = 0; fb < nf; fb += G_FR) {
      float a0[G_FR], a1[G_FR];
      g_conv8<T, K, S>(Ws, tk, k, s, fb, a0, a1);
      if (fb == 0) { h0 = a0[0]; h1 = a1[0]; }
      const int cnt = min(G_FR, nf - fb);  // frames past the tile's end are left out
#pragma unroll
      for (int r = 0; r < G_FR; ++r)
        if (r < cnt) {
          const float d0 = a0[r] - h0, d1 = a1[r] - h1;
          s0 += d0;
          s1 += d1;
          q0 = fmaf(d0, d0, q0);
          q1 = fmaf(d1, d1, q1);
        }
    }
    const float inv = 1.f / (float)nf;
    const float m0 = fmaf(s0, inv, h0), m1 = fmaf(s1, inv, h1);
    q0 = fmaxf(fmaf(-s0 * inv, s0, q0), 0.f);
    q1 = fmaxf(fmaf(-s1 * inv, s1, q1), 0.f);
    *reinterpret_cast<float2*>(pmean + row + c) = make_float2(m0, m1);
    *reinterpret_cast<float2*>(pm2 + row + c) = make_float2(q0, q1);
  }
}

__device__ __forceinline__ float g_gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ unsigned short g_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float g_value(unsigned short bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// one thread per (utterance, channel): its tiles merged in tile order; with a
// table, its first 2 x G_LUT_N threads also write it
__global__ void __launch_bounds__(G_THREADS) conv0_gn_merge_kernel(
    const float* __restrict__ pmean, const float* __restrict__ pm2, float* __restrict__ mean,
    float* __restrict__ rstd, unsigned short* __restrict__ lut, int B, int C, int T0, int tiles,
    float eps) {
  const int i = blockIdx.x * G_THREADS + threadIdx.x;
  if (lut && i < 2 * G_LUT_N)
    lut[i] = g_bits(g_gelu(g_value((unsigned short)((i / G_LUT_N) << 15 |
                                                     (G_LUT_LO + i % G_LUT_N)))));
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float n = 0.f, m = 0.f, q = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const size_t at = ((size_t)b * tiles + t) * C + c;
    g_chan(n, m, q, (float)min(G_TILE, T0 - t * G_TILE), pmean[at], pm2[at]);
  }
  mean[i] = m;
  rstd[i] = rsqrtf(q / n + eps);
}

// byte offset of (channel row, byte of its frames) in the staged chunk: the
// 16-byte units XOR-swizzled by channel pair, so that a warp's 16-byte writes
// of rows 2p (p its lanes) and its reads along one row are free of bank
// conflicts
__device__ __forceinline__ int g_stage(int row, int byte) {
  return row * G_AROW + (((byte >> 4) ^ ((row >> 1) & 7)) << 4) + (byte & 15);
}

// the affine values z of 8 frames of one channel: rounded to the dtype, GELU
// in fp32, rounded, into the stage. In bf16 GELU is the table's entry, the
// formula's bits, where the rounded value lies in the table's range, and the
// formula elsewhere (rare: |y| < 2^-16 or >= 16), taken by a warp only where a
// lane needs it
__device__ __forceinline__ void g_put8(char* st, int row, int f, const float (&z)[G_FR],
                                       const unsigned short*, float) {
  float y[G_FR];
#pragma unroll
  for (int r = 0; r < G_FR; ++r) y[r] = g_gelu(z[r]);
  *reinterpret_cast<float4*>(st + g_stage(row, 4 * f)) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(st + g_stage(row, 4 * f + 16)) =
      make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void g_put8(char* st, int row, int f, const float (&z)[G_FR],
                                       const unsigned short* lut, bf16) {
  unsigned short y[G_FR];
  unsigned miss = 0;
#pragma unroll
  for (int r = 0; r < G_FR; ++r) {
    const unsigned short x = g_bits(z[r]);
    const unsigned mag = (unsigned)(x & 0x7fff) - G_LUT_LO;
    miss |= (mag >= G_LUT_N) << r;
    y[r] = lut[mag < G_LUT_N ? mag + (x >> 15) * G_LUT_N : 0];
    if (mag >= G_LUT_N) y[r] = x;
  }
  if (__any_sync(__activemask(), miss != 0))
#pragma unroll
    for (int r = 0; r < G_FR; ++r)
      if (miss >> r & 1) y[r] = g_bits(g_gelu(g_value(y[r])));
  uint4 u;
  u.x = y[0] | (unsigned)y[1] << 16;
  u.y = y[2] | (unsigned)y[3] << 16;
  u.z = y[4] | (unsigned)y[5] << 16;
  u.w = y[6] | (unsigned)y[7] << 16;
  *reinterpret_cast<uint4*>(st + g_stage(row, 2 * f)) = u;
}

// grid (frame tiles of G_ATILE, channel groups of G_ACH, B). A warp computes
// one eighth of each chunk's frames for 32 channel pairs (its lanes), so the
// strip reads are broadcasts; the chunk (G_AROW bytes of frames a channel)
// passes through shared memory, and each warp stores whole rows of it: runs of
// a kilobyte of one channel, which the card's memory writes at a high rate
// where runs of 128 bytes strewn over every channel did not
template <typename T, int K, int S>
__global__ void __launch_bounds__(G_THREADS, 2) conv0_gn_apply_kernel(
    const T* __restrict__ wav, const T* __restrict__ taps, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float* __restrict__ beta, const unsigned short* __restrict__ lut_g,
    T* __restrict__ out, int T_, int T0, int C, int k, int s) {
  constexpr int FT = G_AROW / sizeof(T);  // frames a chunk stages: 512 (bf16), 256 (fp32)
  constexpr int FQ = FT / (G_THREADS / 32);  // of which each warp computes FQ
  extern __shared__ float4 g_smem4[];
  float* Ws = reinterpret_cast<float*>(g_smem4);
  char* st = reinterpret_cast<char*>(Ws + g_strip(K ? K : k, S ? S : s, G_ATILE));
  unsigned short* lut = reinterpret_cast<unsigned short*>(st + G_ACH * G_AROW);
  const int f0 = blockIdx.x * G_ATILE, c0 = blockIdx.y * G_ACH, b = blockIdx.z;
  const int nf = min(G_ATILE, T0 - f0), rows = min(G_ACH, C - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = c0 + 2 * lane;  // this thread's channels c, c + 1
  g_load_strip(Ws, wav, b, T_, f0, K ? K : k, S ? S : s, G_ATILE);
  if (sizeof(T) == 2)
    for (int e = threadIdx.x; e < 2 * G_LUT_N / 8; e += G_THREADS)
      reinterpret_cast<uint4*>(lut)[e] = reinterpret_cast<const uint4*>(lut_g)[e];
  float2 tk[G_KMAX], mu, rs, g, be;
  if (c < C) {
    g_load_taps(tk, taps, K ? K : k, C, c);
    mu = *reinterpret_cast<const float2*>(mean + (size_t)b * C + c);
    rs = *reinterpret_cast<const float2*>(rstd + (size_t)b * C + c);
    g = *reinterpret_cast<const float2*>(gamma + c);
    be = *reinterpret_cast<const float2*>(beta + c);
  }
  __syncthreads();
  for (int cf = 0; cf < nf; cf += FT) {
    if (c < C) {
#pragma unroll 1
      for (int sub = warp * FQ; sub < (warp + 1) * FQ; sub += G_FR) {
        float a0[G_FR], a1[G_FR];
        g_conv8<T, K, S>(Ws, tk, k, s, cf + sub, a0, a1);
#pragma unroll
        for (int r = 0; r < G_FR; ++r) {
          a0[r] = (a0[r] - mu.x) * rs.x * g.x + be.x;
          a1[r] = (a1[r] - mu.y) * rs.y * g.y + be.y;
        }
        g_put8(st, 2 * lane, sub, a0, lut, T());
        g_put8(st, 2 * lane + 1, sub, a1, lut, T());
      }
    }
    __syncthreads();
    const int nc = min(FT, nf - cf);
    for (int row = warp; row < rows; row += G_THREADS / 32) {
      T* dst = out + ((size_t)b * C + c0 + row) * T0 + f0 + cf;
      for (int e = lane; e < nc; e += 32)
        dst[e] = *reinterpret_cast<const T*>(st + g_stage(row, e * (int)sizeof(T)));
    }
    __syncthreads();
  }
}

template <typename T, int K, int S>
cudaError_t launch_conv0_gn(const void* wav, const void* taps, const float* gamma,
                            const float* beta, float eps, float* part, float* stats, void* out,
                            int B, int T_, int T0, int C, int k, int s, cudaStream_t stream) {
  const int tiles = (T0 + G_TILE - 1) / G_TILE;
  const size_t strip = sizeof(float) * g_strip(k, s, G_TILE);
  const size_t apply_smem = sizeof(float) * g_strip(k, s, G_ATILE) + (size_t)G_ACH * G_AROW +
                            (sizeof(T) == 2 ? 2 * G_LUT_N * sizeof(unsigned short) : 0);
  if (apply_smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv0_gn_apply_kernel<T, K, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)apply_smem);
  if (err != cudaSuccess) return err;
  const T* w = static_cast<const T*>(wav);
  const T* tp = static_cast<const T*>(taps);
  float* pmean = part;
  float* pm2 = part + (size_t)B * tiles * C;
  float* mean = stats;
  float* rstd = stats + (size_t)B * C;
  unsigned short* lut =
      sizeof(T) == 2 ? reinterpret_cast<unsigned short*>(stats + 2 * (size_t)B * C) : nullptr;
  const int merge_threads = sizeof(T) == 2 && B * C < 2 * G_LUT_N ? 2 * G_LUT_N : B * C;
  conv0_gn_stats_kernel<T, K, S><<<dim3(tiles, B), G_THREADS, strip, stream>>>(
      w, tp, pmean, pm2, T_, T0, C, k, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv0_gn_merge_kernel<<<(merge_threads + G_THREADS - 1) / G_THREADS, G_THREADS, 0, stream>>>(
      pmean, pm2, mean, rstd, lut, B, C, T0, tiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((T0 + G_ATILE - 1) / G_ATILE, (C + G_ACH - 1) / G_ACH, B);
  conv0_gn_apply_kernel<T, K, S><<<grid, G_THREADS, apply_smem, stream>>>(
      w, tp, mean, rstd, gamma, beta, lut, static_cast<T*>(out), T_, T0, C, k, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_conv0_gn(const void* wav, const void* taps, const float* gamma,
                              const float* beta, float eps, float* part, float* stats, void* out,
                              int B, int T_, int T0, int C, int k, int s, cudaStream_t stream) {
  if (k == 10 && s == 5)
    return launch_conv0_gn<T, 10, 5>(wav, taps, gamma, beta, eps, part, stats, out, B, T_, T0,
                                     C, k, s, stream);
  return launch_conv0_gn<T, 0, 0>(wav, taps, gamma, beta, eps, part, stats, out, B, T_, T0, C,
                                  k, s, stream);
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

// wav (B, T) and taps (k, C) contiguous in one dtype (fp32, or bf16 when
// bf16); gamma, beta (C) fp32; part fp32 scratch of 2 x B x tiles x C and stats
// of 2 x B x C + 2560 (mean, rstd, then the bf16 GELU table), tiles =
// ceil(T0 / 256); out (B, C, T0) in the
// dtype, T0 = (T - k) / s + 1 >= 1. C even, k <= 10. Three launches, in order
// on `stream`. Returns a cudaError_t.
int sc_conv0_gn_gelu(const void* wav, const void* taps, const float* gamma, const float* beta,
                     float eps, float* part, float* stats, void* out, int B, int T, int C,
                     int k, int s, int bf16_io, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || C % 2 || k <= 0 || k > G_KMAX || s <= 0 || T < k || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int T0 = (T - k) / s + 1;
  const cudaError_t err =
      bf16_io ? dispatch_conv0_gn<bf16>(wav, taps, gamma, beta, eps, part, stats, out, B, T, T0,
                                        C, k, s, stream)
              : dispatch_conv0_gn<float>(wav, taps, gamma, beta, eps, part, stats, out, B, T, T0,
                                         C, k, s, stream);
  return (int)err;
}

}  // extern "C"
