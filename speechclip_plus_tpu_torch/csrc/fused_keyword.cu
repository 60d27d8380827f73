// Fused cosine-score -> VQ statistics, forward (K3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// speechclip_plus_tpu/ops/fused_keyword.py:92 (launched by
// `_pallas_fwd_call`, :178, from `fused_cosine_vq`, :290). For N keyword
// rows x (N, D) against the normalized codebook en (V, D) it computes the
// masked scores s = x . en^T and, per row, the argmax k (ties to the lowest
// index, as jnp.argmax), the entropy ent = log z - sum e (s - m) / z, and the
// column sums psum[v] = sum_rows softmax(s)[v]. Masked columns (CLIP special
// ids) score -1e30.
//
// What bounds it on the H100. At the serving shape (N = B*75 rows, V = 8112,
// D = 512) the (N, V) fp32 score matrix is 19 MB per 1000 rows; the TPU kept
// its tiles in VMEM against a resident codebook. A block here cannot hold the
// 8 MB bf16 table, so the kernel streams 64-column tiles of en and 32-row
// tiles of x through shared memory, and no (N, V) tensor reaches device
// memory. The TPU grid carried psum from one grid step to the next; blocks
// here run in no order, so the work is split into passes:
//
//   1. vq_rows_kernel: grid (row tiles, V splits). Each block keeps a running
//      argmax, max m, sum z and sum e (s - m) per row over its V range,
//      rescaling when m grows, and writes them per split.
//   2. vq_combine_kernel: merges the splits in column order -> k, ent, m, z.
//   3. vq_cols_kernel: grid (column tiles, row chunks); recomputes s tile by
//      tile and sums exp(s - m) / z over the chunk's rows.
//   4. vq_reduce_kernel: sums the chunk partials in a fixed order.
//
// No float atomics anywhere, so repeated runs give identical statistics.
// Simple first: scores are fp32 FMAs from shared memory (bf16 inputs are
// widened on load), recomputed once for the column pass; tensor cores and
// keeping psum in the row pass are later work.
//
// Straight-through backward (K3b). Replaces `_bwd_kernel` of
// speechclip_plus_tpu/ops/fused_keyword.py:123 (launched by
// `_pallas_bwd_call`, :210, from `_st_gather`'s VJP, :269): for the keyword
// cotangent g (N, D) it computes, with s = x . en^T (masked columns out),
// u = (g . en^T) * ||emb||, p = softmax(s / t), rho = sum p u,
// dz = p (u - rho) (0 on masked columns):
//   dx = (dz / t) . en  (N, D) fp32,   dt = sum dz * (-s / t^2).
// The TPU held the table resident and the (R, V) tiles of s, u and p in
// VMEM; here a block owns 32 rows and streams V twice (vq_bwd_rows_kernel):
//   pass 1 keeps the running max, sum e and sum e u of softmax(s / t);
//   pass 2 recomputes s and u, forms dz and accumulates dx in shared memory
//   and a per-block partial of dt, which vq_bwd_dt_kernel sums in a fixed
//   order. g and dz / t are rounded to the compute dtype before their
//   products, as on the TPU (:139, :146-149). No codebook gradient: the
//   table is frozen (the wrapper enforces it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

constexpr int VR = 32;          // rows per score tile
constexpr int VC = 64;          // columns per score tile
constexpr int VD = 64;          // D chunk staged in shared memory
constexpr int V_THREADS = 256;  // thread (ty, tx): rows ty*2+i (i<2), cols tx+16j (j<4)
constexpr int V_SPLITS = 8;     // V ranges per row tile in the row pass
constexpr int ROW_CHUNK = 256;  // rows per block in the column pass
constexpr float MASK_VALUE = -1e30f;
constexpr float INIT_MAX = -3e38f;

// s[i][j] = x[r0 + ty*2 + i] . en[c0 + tx + 16 j], zero outside N / V.
// Starts with a barrier, so consecutive calls may reuse the staging buffers.
template <typename T>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ x, const T* __restrict__ en, int N, int V, int D,
    int r0, int c0, float (*xs)[VD + 1], float (*es)[VD + 1], float s[2][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += VD) {
    __syncthreads();
    for (int e = tid; e < VR * VD; e += V_THREADS) {
      const int r = e / VD, d = e % VD, gr = r0 + r, gd = d0 + d;
      xs[r][d] = (gr < N && gd < D) ? to_f(x[(size_t)gr * D + gd]) : 0.f;
    }
    for (int e = tid; e < VC * VD; e += V_THREADS) {
      const int c = e / VD, d = e % VD, gc = c0 + c, gd = d0 + d;
      es[c][d] = (gc < V && gd < D) ? to_f(en[(size_t)gc * D + gd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < VD; ++d) {
      float a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = xs[ty * 2 + i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = es[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
}

// Merge softmax statistics (m, z, t = sum e (s - m)) of two column sets.
__device__ __forceinline__ void merge_stats(float& m, float& z, float& t,
                                            float m2, float z2, float t2) {
  const float mn = fmaxf(m, m2);
  const float a = expf(m - mn), b = expf(m2 - mn);
  t = a * (t + z * (m - mn)) + b * (t2 + z2 * (m2 - mn));
  z = a * z + b * z2;
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(V_THREADS) vq_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ en, const int* __restrict__ mask,
    int N, int V, int D, int cols_per_split,
    float* __restrict__ pm, float* __restrict__ pz, float* __restrict__ pt,
    float* __restrict__ pbv, int* __restrict__ pbi) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * VR, split = blockIdx.y;
  const int cbeg = split * cols_per_split;
  const int cend = min(V, cbeg + cols_per_split);
  float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float bv[2] = {INIT_MAX, INIT_MAX};
  int bi[2] = {-1, -1};

  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    float s[2][4];
    score_tile<T>(x, en, N, V, D, r0, c0, xs, es, s);
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      valid[j] = c < cend;
      if (valid[j] && mask[c]) {
        s[0][j] = MASK_VALUE;
        s[1][j] = MASK_VALUE;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tm = INIT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!valid[j]) continue;
        tm = fmaxf(tm, s[i][j]);
        if (s[i][j] > bv[i]) {  // columns rise with j: strict > keeps the lowest
          bv[i] = s[i][j];
          bi[i] = c0 + tx + 16 * j;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      float te = 0.f, tt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!valid[j]) continue;
        const float e = expf(s[i][j] - tm);
        te += e;
        tt += e * (s[i][j] - tm);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        te += __shfl_xor_sync(0xffffffffu, te, off);
        tt += __shfl_xor_sync(0xffffffffu, tt, off);
      }
      merge_stats(m[i], z[i], t[i], tm, te, tt);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float obv = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int obi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (obv > bv[i] || (obv == bv[i] && obi >= 0 && (bi[i] < 0 || obi < bi[i]))) {
        bv[i] = obv;
        bi[i] = obi;
      }
    }
    const int row = r0 + ty * 2 + i;
    if (tx == 0 && row < N) {
      const size_t o = (size_t)split * N + row;
      pm[o] = m[i];
      pz[o] = z[i];
      pt[o] = t[i];
      pbv[o] = bv[i];
      pbi[o] = bi[i];
    }
  }
}

__global__ void vq_combine_kernel(
    const float* __restrict__ pm, const float* __restrict__ pz, const float* __restrict__ pt,
    const float* __restrict__ pbv, const int* __restrict__ pbi, int N, int splits,
    int* __restrict__ k, float* __restrict__ ent, float* __restrict__ m_out,
    float* __restrict__ z_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = INIT_MAX, z = 0.f, t = 0.f, bv = INIT_MAX;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {  // splits cover rising column ranges
    const size_t o = (size_t)s * N + row;
    merge_stats(m, z, t, pm[o], pz[o], pt[o]);
    if (pbi[o] >= 0 && pbv[o] > bv) {
      bv = pbv[o];
      bi = pbi[o];
    }
  }
  k[row] = bi;
  ent[row] = logf(z) - t / z;
  m_out[row] = m;
  z_out[row] = z;
}

template <typename T>
__global__ void __launch_bounds__(V_THREADS) vq_cols_kernel(
    const T* __restrict__ x, const T* __restrict__ en, const int* __restrict__ mask,
    const float* __restrict__ m_row, const float* __restrict__ z_row,
    int N, int V, int D, float* __restrict__ part) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  __shared__ float red[16][VC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * VC, chunk = blockIdx.y;
  const int rbeg = chunk * ROW_CHUNK, rend = min(N, rbeg + ROW_CHUNK);
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 16 * j;
    live[j] = c < V && !mask[c];
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = rbeg; r0 < rend; r0 += VR) {
    float s[2][4];
    score_tile<T>(x, en, N, V, D, r0, c0, xs, es, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty * 2 + i;
      if (row >= rend) continue;
      const float mr = m_row[row], zr = z_row[row];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j]) acc[j] += expf(s[i][j] - mr) / zr;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = acc[j];
  __syncthreads();
  if (tid < VC && c0 + tid < V) {
    float sum = 0.f;
    for (int g = 0; g < 16; ++g) sum += red[g][tid];
    part[(size_t)chunk * V + c0 + tid] = sum;
  }
}

__global__ void vq_reduce_kernel(const float* __restrict__ part, int chunks, int V,
                                 float* __restrict__ psum) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= V) return;
  float sum = 0.f;
  for (int i = 0; i < chunks; ++i) sum += part[(size_t)i * V + c];
  psum[c] = sum;
}

// ------------------------------------------------ K3b: ST backward ----

constexpr int BW_D = 64;  // D columns per dx update step

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// s[i][j] = x[r] . en[c], u[i][j] = g[r] . en[c] for rows r0 + ty*2 + i and
// columns c0 + tx + 16 j; zero outside N / V. Starts with a barrier.
template <typename T>
__device__ __forceinline__ void score_pair_tile(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ en, int N,
    int V, int D, int r0, int c0, float (*xs)[VD + 1], float (*gs)[VD + 1],
    float (*es)[VD + 1], float s[2][4], float u[2][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = u[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += VD) {
    __syncthreads();
    for (int e = tid; e < VR * VD; e += V_THREADS) {
      const int r = e / VD, d = e % VD, gr = r0 + r, gd = d0 + d;
      const bool in = gr < N && gd < D;
      xs[r][d] = in ? to_f(x[(size_t)gr * D + gd]) : 0.f;
      gs[r][d] = in ? to_f(g[(size_t)gr * D + gd]) : 0.f;
    }
    for (int e = tid; e < VC * VD; e += V_THREADS) {
      const int c = e / VD, d = e % VD, gc = c0 + c, gd = d0 + d;
      es[c][d] = (gc < V && gd < D) ? to_f(en[(size_t)gc * D + gd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < VD; ++d) {
      float a[2], b2[2], e4[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = xs[ty * 2 + i][d];
        b2[i] = gs[ty * 2 + i][d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) e4[j] = es[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], e4[j], s[i][j]);
          u[i][j] = fmaf(b2[i], e4[j], u[i][j]);
        }
    }
  }
}

// Block = 32 rows; dynamic shared memory holds the (32, D) dx accumulator.
template <typename T>
__global__ void __launch_bounds__(V_THREADS) vq_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ en,
    const float* __restrict__ norms, const int* __restrict__ mask, int N, int V, int D,
    float inv_t, float* __restrict__ dx, float* __restrict__ dt_part) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float gs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  __shared__ float ws[VR][VC + 1];
  __shared__ float red[V_THREADS];
  extern __shared__ float dxs[];  // [VR][D]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * VR;
  for (int e = tid; e < VR * D; e += V_THREADS) dxs[e] = 0.f;

  // pass 1: m, z = sum e, zu = sum e u of softmax(s / t) over unmasked columns
  float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, zu[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < V; c0 += VC) {
    float s[2][4], u[2][4];
    score_pair_tile<T>(x, g, en, N, V, D, r0, c0, xs, gs, es, s, u);
    bool live[4];
    float nrm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      live[j] = c < V && !mask[c];
      nrm[j] = c < V ? norms[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tm = INIT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j]) tm = fmaxf(tm, s[i][j] * inv_t);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      float te = 0.f, tu = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
        const float e = expf(s[i][j] * inv_t - tm);
        te += e;
        tu += e * (u[i][j] * nrm[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        te += __shfl_xor_sync(0xffffffffu, te, off);
        tu += __shfl_xor_sync(0xffffffffu, tu, off);
      }
      const float mn = fmaxf(m[i], tm);
      const float a = expf(m[i] - mn), bb = expf(tm - mn);
      z[i] = a * z[i] + bb * te;
      zu[i] = a * zu[i] + bb * tu;
      m[i] = mn;
    }
  }
  float rho[2], inv_z[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    inv_z[i] = 1.f / z[i];
    rho[i] = zu[i] * inv_z[i];
  }

  // pass 2: dz, dt, and dx += round(dz / t) . en
  float dt_acc = 0.f;
  for (int c0 = 0; c0 < V; c0 += VC) {
    float s[2][4], u[2][4];
    score_pair_tile<T>(x, g, en, N, V, D, r0, c0, xs, gs, es, s, u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      const bool live = c < V && !mask[c];
      const float nrm = c < V ? norms[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float w = 0.f;
        if (live && r0 + ty * 2 + i < N) {
          const float p = expf(s[i][j] * inv_t - m[i]) * inv_z[i];
          const float dz = p * (u[i][j] * nrm - rho[i]);
          dt_acc += dz * (-s[i][j] * inv_t * inv_t);
          w = round_to<T>(dz * inv_t);
        }
        ws[ty * 2 + i][tx + 16 * j] = w;
      }
    }
    for (int d0 = 0; d0 < D; d0 += BW_D) {
      __syncthreads();  // ws written; the previous es tile consumed
      for (int e = tid; e < VC * BW_D; e += V_THREADS) {
        const int c = e / BW_D, d = e % BW_D, gc = c0 + c, gd = d0 + d;
        es[c][d] = (gc < V && gd < D) ? to_f(en[(size_t)gc * D + gd]) : 0.f;
      }
      __syncthreads();
      float acc[2][4] = {};
#pragma unroll 8
      for (int c = 0; c < VC; ++c) {
        float e4[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) e4[jj] = es[c][tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float w = ws[ty * 2 + i][c];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(w, e4[jj], acc[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int d = d0 + tx + 16 * jj;
          if (d < D) dxs[(ty * 2 + i) * D + d] += acc[i][jj];
        }
    }
    __syncthreads();  // ws and es are rewritten by the next column tile
  }

  for (int e = tid; e < VR * D; e += V_THREADS) {
    const int r = e / D;
    if (r0 + r < N) dx[(size_t)r0 * D + e] = dxs[e];
  }
  red[tid] = dt_acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < V_THREADS; ++i) sum += red[i];
    dt_part[blockIdx.x] = sum;
  }
}

__global__ void vq_bwd_dt_kernel(const float* __restrict__ part, int n, float* __restrict__ dt) {
  float sum = 0.f;
  for (int i = 0; i < n; ++i) sum += part[i];
  dt[0] = sum;
}

template <typename T>
cudaError_t launch_vq_bwd(const void* x, const void* g, const void* en, const float* norms,
                          const int* mask, int N, int V, int D, float t, float* dx,
                          float* dt_part, float* dt, cudaStream_t stream) {
  const size_t smem = sizeof(float) * VR * D;
  cudaError_t err = cudaFuncSetAttribute(
      vq_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + VR - 1) / VR;
  vq_bwd_rows_kernel<T><<<tiles, V_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(en), norms,
      mask, N, V, D, 1.f / t, dx, dt_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_bwd_dt_kernel<<<1, 1, 0, stream>>>(dt_part, tiles, dt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vq(const void* xv, const void* env, const int* mask, int N, int V, int D,
                      float* part_f, int* part_i, float* col_part, int* k, float* ent,
                      float* m, float* z, float* psum, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* en = static_cast<const T*>(env);
  const int col_tiles = (V + VC - 1) / VC;
  const int cols_per_split = ((col_tiles + V_SPLITS - 1) / V_SPLITS) * VC;
  const size_t sn = (size_t)V_SPLITS * N;
  float *pm = part_f, *pz = part_f + sn, *pt = part_f + 2 * sn, *pbv = part_f + 3 * sn;
  vq_rows_kernel<T><<<dim3((N + VR - 1) / VR, V_SPLITS), V_THREADS, 0, stream>>>(
      x, en, mask, N, V, D, cols_per_split, pm, pz, pt, pbv, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      pm, pz, pt, pbv, part_i, N, V_SPLITS, k, ent, m, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (N + ROW_CHUNK - 1) / ROW_CHUNK;
  vq_cols_kernel<T><<<dim3(col_tiles, chunks), V_THREADS, 0, stream>>>(
      x, en, mask, m, z, N, V, D, col_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_reduce_kernel<<<(V + 255) / 256, 256, 0, stream>>>(col_part, chunks, V, psum);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch sizes the caller allocates.
int sc_vq_splits(void) { return V_SPLITS; }
int sc_vq_row_chunk(void) { return ROW_CHUNK; }

// x (N, D), en (V, D): fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), row-major.
// mask (V,) int32, nonzero = excluded column. Scratch: part_f 4*splits*N
// floats, part_i splits*N ints, col_part chunks*V floats. Outputs: k (N,)
// int32, ent/m/z (N,) fp32, psum (V,) fp32. Returns a cudaError_t.
// Straight-through backward. x, g (N, D) and en (V, D) in the compute dtype
// (is_bf16), norms (V,) fp32 = ||emb||, mask (V,) int32, t the temperature.
// Outputs: dx (N, D) fp32, dt (1,) fp32; scratch dt_part (ceil(N / row
// tile),) fp32. D <= 1024 (the dx tile lives in shared memory). Returns a
// cudaError_t.
int sc_vq_bwd(const void* x, const void* g, const void* en, const float* norms,
              const int* mask, int N, int V, int D, float t, int is_bf16, float* dx,
              float* dt_part, float* dt, cudaStream_t stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D > 1024 || !(t > 0.f)) return (int)cudaErrorInvalidValue;
  cudaError_t err = is_bf16
      ? launch_vq_bwd<bf16>(x, g, en, norms, mask, N, V, D, t, dx, dt_part, dt, stream)
      : launch_vq_bwd<float>(x, g, en, norms, mask, N, V, D, t, dx, dt_part, dt, stream);
  return (int)err;
}

int sc_vq_fwd(const void* x, const void* en, const int* mask, int N, int V, int D,
              int is_bf16, float* part_f, int* part_i, float* col_part, int* k,
              float* ent, float* m, float* z, float* psum, cudaStream_t stream) {
  if (N <= 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = is_bf16
      ? launch_vq<bf16>(x, en, mask, N, V, D, part_f, part_i, col_part, k, ent, m, z, psum, stream)
      : launch_vq<float>(x, en, mask, N, V, D, part_f, part_i, col_part, k, ent, m, z, psum, stream);
  return (int)err;
}

}  // extern "C"
