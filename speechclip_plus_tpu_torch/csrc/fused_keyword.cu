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
// VMEM. Here the work is 5 N x D x V products (s and u twice, then dx: 399
// GFLOP at N = 9600, D = 512, V = 8112) against a few MB of traffic, so it is
// bound by operations, and no (N, V) tensor reaches device memory. In bf16
// the products run on the tensor cores (`mma.sync` m16n8k16, bf16 operands,
// fp32 accumulators: the products are exact, as on the MXU; only the order of
// the sums differs); fp32 keeps an FMA tile. The grid is (row tiles, V
// splits), the split count chosen by the wrapper so that every row count
// fills the card's 132 SMs; the passes are described at K3b's code. g and
// dz / t are rounded to the compute dtype before their products, as on the
// TPU (:139, :146-149). No float atomics: reruns are bit-identical. No
// codebook gradient: the table is frozen (the wrapper enforces it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "numeric.cuh"

namespace {

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
//
// Both tiles run on the grid (row tiles, V splits) that the wrapper's plan
// chooses (`_bwd_plan`): split k owns the whole 64-column tiles
// [k * cols_per_split, (k + 1) * cols_per_split) of V.
//   pass 1 (DX = false): per block, the running (m, z = sum e, zu = sum e u)
//     of softmax(s / t) over the split's columns -> stats [3][splits][N];
//   pass 2 (DX = true): per block, the splits' statistics merged in column
//     order (m, 1 / z, rho), then s and u again, dz, a partial of dt, and the
//     split's partial dx -> dx itself when there is one split, else
//     dx_part [splits][N][D];
//   pass 3: vq_bwd_reduce_kernel sums the partial dx in split order and
//     vq_bwd_dt_kernel the dt partials in (row tile, split) order.

// Merge the statistics (m, z, zu) of two column sets. An empty set (m =
// INIT_MAX, z = zu = 0) merges as the identity: exp(INIT_MAX - INIT_MAX) = 1
// multiplies zeros, exp(INIT_MAX - m) = 0 for any real m.
__device__ __forceinline__ void merge_ezu(float& m, float& z, float& zu, float m2, float z2,
                                          float zu2) {
  const float mn = fmaxf(m, m2);
  const float a = expf(m - mn), b = expf(m2 - mn);
  z = a * z + b * z2;
  zu = a * zu + b * zu2;
  m = mn;
}

// out = (m, 1 / z, rho = zu / z) of `row`, its splits merged in column order;
// zeros for a row past N, so that its p, dz and w are 0
__device__ __forceinline__ void merged_row(const float* __restrict__ stats, int splits, int N,
                                           int row, float* out) {
  if (row >= N) {
    out[0] = out[1] = out[2] = 0.f;
    return;
  }
  const size_t sn = (size_t)splits * N;
  float m = INIT_MAX, z = 0.f, zu = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = (size_t)sp * N + row;
    merge_ezu(m, z, zu, stats[o], stats[sn + o], stats[2 * sn + o]);
  }
  const float iz = 1.f / z;
  out[0] = m;
  out[1] = iz;
  out[2] = zu * iz;
}

// ---- fp32: the FMA tile (32 rows, 256 threads, fp32 products) ----

constexpr int BW_D = 64;  // D columns per dx update step

// s[i][j] = x[r] . en[c], u[i][j] = g[r] . en[c] for rows r0 + ty*2 + i and
// columns c0 + tx + 16 j; zero outside N / V. Starts with a barrier.
__device__ __forceinline__ void score_pair_tile(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ en,
    int N, int V, int D, int r0, int c0, float (*xs)[VD + 1], float (*gs)[VD + 1],
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
      xs[r][d] = in ? x[(size_t)gr * D + gd] : 0.f;
      gs[r][d] = in ? g[(size_t)gr * D + gd] : 0.f;
    }
    for (int e = tid; e < VC * VD; e += V_THREADS) {
      const int c = e / VD, d = e % VD, gc = c0 + c, gd = d0 + d;
      es[c][d] = (gc < V && gd < D) ? en[(size_t)gc * D + gd] : 0.f;
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

// Block = (32 rows, one split); pass 2's dynamic shared memory holds the
// (32, D) dx accumulator.
template <bool DX>
__global__ void __launch_bounds__(V_THREADS) vq_bwd_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ en,
    const float* __restrict__ norms, const int* __restrict__ mask, int N, int V, int D,
    int splits, int cols_per_split, float inv_t, float* __restrict__ stats,
    float* __restrict__ dx_out, float* __restrict__ dt_part) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float gs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  __shared__ float ws[VR][VC + 1];
  __shared__ float red[V_THREADS];
  __shared__ float rowst[VR][3];
  extern __shared__ float dxs[];  // [VR][D]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * VR, split = blockIdx.y;
  const int cbeg = split * cols_per_split, cend = min(V, cbeg + cols_per_split);

  if (!DX) {
    float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, zu[2] = {0.f, 0.f};
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      float s[2][4], u[2][4];
      score_pair_tile(x, g, en, N, V, D, r0, c0, xs, gs, es, s, u);
      bool live[4];
      float nrm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        live[j] = c < cend && !mask[c];
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
        merge_ezu(m[i], z[i], zu[i], tm, te, tu);
      }
    }
    const size_t sn = (size_t)splits * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty * 2 + i;
      if (tx == 0 && row < N) {
        const size_t o = (size_t)split * N + row;
        stats[o] = m[i];
        stats[sn + o] = z[i];
        stats[2 * sn + o] = zu[i];
      }
    }
    return;
  }

  for (int e = tid; e < VR * D; e += V_THREADS) dxs[e] = 0.f;
  if (tid < VR) merged_row(stats, splits, N, r0 + tid, rowst[tid]);
  __syncthreads();
  float mr[2], iz[2], rho[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mr[i] = rowst[ty * 2 + i][0];
    iz[i] = rowst[ty * 2 + i][1];
    rho[i] = rowst[ty * 2 + i][2];
  }

  // dz, dt, and dx += (dz / t) . en
  float dt_acc = 0.f;
  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    float s[2][4], u[2][4];
    score_pair_tile(x, g, en, N, V, D, r0, c0, xs, gs, es, s, u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      const bool live = c < cend && !mask[c];
      const float nrm = c < V ? norms[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float w = 0.f;
        if (live && r0 + ty * 2 + i < N) {
          const float p = expf(s[i][j] * inv_t - mr[i]) * iz[i];
          const float dz = p * (u[i][j] * nrm - rho[i]);
          dt_acc += dz * (-s[i][j] * inv_t * inv_t);
          w = dz * inv_t;
        }
        ws[ty * 2 + i][tx + 16 * j] = w;
      }
    }
    for (int d0 = 0; d0 < D; d0 += BW_D) {
      __syncthreads();  // ws written; the previous es tile consumed
      for (int e = tid; e < VC * BW_D; e += V_THREADS) {
        const int c = e / BW_D, d = e % BW_D, gc = c0 + c, gd = d0 + d;
        es[c][d] = (gc < V && gd < D) ? en[(size_t)gc * D + gd] : 0.f;
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

  float* out = dx_out + (size_t)split * N * D;
  for (int e = tid; e < VR * D; e += V_THREADS) {
    const int r = e / D;
    if (r0 + r < N) out[(size_t)r0 * D + e] = dxs[e];
  }
  red[tid] = dt_acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < V_THREADS; ++i) sum += red[i];
    dt_part[blockIdx.x * splits + split] = sum;
  }
}

// ---- bf16: the tensor-core tile (64 rows, 8 warps, mma.sync m16n8k16) ----
//
// The block keeps its x and g rows and one 64-column tile of en in shared
// memory (bf16 rows padded by 16 bytes, so that the 8 row addresses of an
// `ldmatrix` fall on distinct banks; 208 KB at D = 512: one block an SM).
// Warp (rg, ch) forms s = x . en^T and u = g . en^T for rows 16 rg.. and
// columns 32 ch.. of the tile, reading x, g and en by `ldmatrix`; pass 2
// rounds w = dz / t to bf16 into a (64, 64) shared tile, and warp k
// multiplies all 64 rows of w by columns [64 k, 64 k + 64) of the same en
// tile (`ldmatrix.trans`: en is the B operand as it lies), keeping that
// (64, 64) part of dx in 128 registers a thread for the whole split.

constexpr int TR = 64;         // rows per block
constexpr int T_THREADS = 256;
constexpr int T_DMAX = 512;    // the dx accumulators cover D = 8 warps x 64 columns
constexpr int TPAD = 8;        // bf16 padding of a shared row
constexpr int WLD = VC + TPAD;  // row stride of the w tile

size_t tc_smem_bytes(int D) {
  return sizeof(bf16) * ((size_t)(2 * TR + VC) * (D + TPAD) + (size_t)TR * WLD) +
         sizeof(float) * (2 * VC + 2 * TR * 3 + T_THREADS / 32);
}

// columns [c0, c0 + 64) of en into es (zeros from cend on) in 4 commit groups,
// one a quarter of D's 16-wide steps; and the tile's norms and live flags
__device__ __forceinline__ void load_en_tile(bf16* es, float* nrm, int* live,
                                             const bf16* __restrict__ en,
                                             const float* __restrict__ norms,
                                             const int* __restrict__ mask, int cend, int D,
                                             int ld, int c0) {
  const int steps = D / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k0 = q * steps / 4 * 2, w = (q + 1) * steps / 4 * 2 - k0;  // 16-byte chunks
    for (int e = threadIdx.x; e < VC * w; e += T_THREADS) {
      const int r = e / w, ck = k0 + e % w, c = c0 + r;
      const bool in = c < cend;
      cp_async16(smem_u32(es + r * ld + ck * 8), en + (size_t)(in ? c : 0) * D + ck * 8, in);
    }
    cp_async_commit();
  }
  if (threadIdx.x < VC) {
    const int c = c0 + threadIdx.x;
    live[threadIdx.x] = c < cend && !mask[c];
    nrm[threadIdx.x] = c < cend ? norms[c] : 0.f;
  }
}

// s and u of the warp's 16 rows and 32 columns (4 n8 tiles): waits for the en
// tile's groups one by one, so that the later quarters of D arrive under the
// products of the earlier ones. x_at, g_at and e_at are the lane's ldmatrix
// addresses at k = 0. Its first barrier also publishes the tile's flags.
__device__ __forceinline__ void su_tile(uint32_t x_at, uint32_t g_at, uint32_t e_at, int D,
                                        int ld, float (&s)[4][4], float (&u)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = u[j][e] = 0.f;
  const int steps = D / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cp_async_wait(3 - q);
    __syncthreads();
    const int k_end = (q + 1) * steps / 4;
    for (int ks = q * steps / 4; ks < k_end; ++ks) {
      const uint32_t ko = ks * 16 * sizeof(bf16);
      uint32_t xa[4], ga[4];
      ldsm_x4(xa, x_at + ko);
      ldsm_x4(ga, g_at + ko);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, e_at + jj * 16 * ld * sizeof(bf16) + ko);
        mma_bf16(s[2 * jj], xa, b[0], b[1]);
        mma_bf16(u[2 * jj], ga, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], xa, b[2], b[3]);
        mma_bf16(u[2 * jj + 1], ga, b[2], b[3]);
      }
    }
  }
}

template <bool DX>
__global__ void __launch_bounds__(T_THREADS, 1) vq_bwd_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ en,
    const float* __restrict__ norms, const int* __restrict__ mask, int N, int V, int D,
    int splits, int cols_per_split, float inv_t, float* __restrict__ stats,
    float* __restrict__ dx_out, float* __restrict__ dt_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + TPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + TR * ld;
  bf16* es = gs + TR * ld;
  bf16* ws = es + VC * ld;
  float* nrm = reinterpret_cast<float*>(ws + TR * WLD);
  int* live = reinterpret_cast<int*>(nrm + VC);
  float* rowst = reinterpret_cast<float*>(live + VC);  // [2][TR][3]
  float* red = rowst + 2 * TR * 3;                     // [T_THREADS / 32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;  // s and u: rows 16 rg.., columns 32 ch..
  const int r0 = blockIdx.x * TR, split = blockIdx.y;
  const int cbeg = split * cols_per_split, cend = min(V, cbeg + cols_per_split);

  // x and g rows, zeros past N: one commit group, which the first tile's
  // first wait covers
  const int chunks = D / 8;
  for (int e = tid; e < TR * chunks; e += T_THREADS) {
    const int r = e / chunks, ck = e % chunks;
    const bool in = r0 + r < N;
    const size_t o = (size_t)(in ? r0 + r : 0) * D + ck * 8;
    cp_async16(smem_u32(xs + r * ld + ck * 8), x + o, in);
    cp_async16(smem_u32(gs + r * ld + ck * 8), g + o, in);
  }
  cp_async_commit();
  const uint32_t x_at = smem_u32(xs + (16 * rg + (lane & 15)) * ld + (lane >> 4) * 8);
  const uint32_t g_at = x_at + TR * ld * sizeof(bf16);
  const uint32_t e_at =
      smem_u32(es + (32 * ch + (lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);

  if (!DX) {
    float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, zu[2] = {0.f, 0.f};
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      load_en_tile(es, nrm, live, en, norms, mask, cend, D, ld, c0);
      float s[4][4], u[4][4];
      su_tile(x_at, g_at, e_at, D, ld, s, u);
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows gq + 8 i: accumulator entries 2 i, 2 i + 1
        float tm = INIT_MAX;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (live[32 * ch + 8 * j + 2 * tq + e]) tm = fmaxf(tm, s[j][2 * i + e] * inv_t);
        float te = 0.f, tu = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 32 * ch + 8 * j + 2 * tq + e;
            if (!live[col]) continue;
            const float ee = expf(s[j][2 * i + e] * inv_t - tm);
            te += ee;
            tu += ee * (u[j][2 * i + e] * nrm[col]);
          }
        merge_ezu(m[i], z[i], zu[i], tm, te, tu);
      }
      __syncthreads();  // es, nrm and live are rewritten by the next tile
    }
    cp_async_wait(0);
    // the quad's four column sets, then the two warps of a row group
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float z2 = __shfl_xor_sync(0xffffffffu, z[i], off);
        const float zu2 = __shfl_xor_sync(0xffffffffu, zu[i], off);
        merge_ezu(m[i], z[i], zu[i], m2, z2, zu2);
      }
      if (tq == 0) {
        float* o = rowst + (ch * TR + 16 * rg + gq + 8 * i) * 3;
        o[0] = m[i];
        o[1] = z[i];
        o[2] = zu[i];
      }
    }
    __syncthreads();
    if (tid < TR && r0 + tid < N) {
      const float* a = rowst + tid * 3;
      const float* b = rowst + (TR + tid) * 3;
      float mm = a[0], zz = a[1], zzu = a[2];
      merge_ezu(mm, zz, zzu, b[0], b[1], b[2]);
      const size_t sn = (size_t)splits * N, o = (size_t)split * N + r0 + tid;
      stats[o] = mm;
      stats[sn + o] = zz;
      stats[2 * sn + o] = zzu;
    }
    return;
  }

  if (tid < TR) merged_row(stats, splits, N, r0 + tid, rowst + tid * 3);  // read after a barrier
  float acc[4][8][4];  // dx: rows 16 mi + .., columns 64 warp + 8 n + ..
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  float dt_acc = 0.f;
  const int d_base = 64 * warp;
  const uint32_t w_at = smem_u32(ws + (lane & 15) * WLD + (lane >> 4) * 8);
  const uint32_t et_at =
      smem_u32(es + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + d_base + (lane >> 4) * 8);
  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    load_en_tile(es, nrm, live, en, norms, mask, cend, D, ld, c0);
    float s[4][4], u[4][4];
    su_tile(x_at, g_at, e_at, D, ld, s, u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * rg + gq + 8 * i;
      const float mr = rowst[row * 3], iz = rowst[row * 3 + 1], rho = rowst[row * 3 + 2];
      const bool row_ok = r0 + row < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * ch + 8 * j + 2 * tq;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          w[e] = 0.f;
          if (row_ok && live[col + e]) {
            const float sv = s[j][2 * i + e];
            const float p = expf(sv * inv_t - mr) * iz;
            const float dz = p * (u[j][2 * i + e] * nrm[col + e] - rho);
            dt_acc += dz * (-sv * inv_t * inv_t);
            w[e] = dz * inv_t;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(ws + row * WLD + col) =
            __floats2bfloat162_rn(w[0], w[1]);
      }
    }
    __syncthreads();  // w complete
    if (d_base < D) {
#pragma unroll
      for (int ks = 0; ks < VC / 16; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(a[mi], w_at + (mi * 16 * WLD + ks * 16) * sizeof(bf16));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (d_base + 16 * jj >= D) continue;
          uint32_t b[4];
          ldsm_x4_trans(b, et_at + (ks * 16 * ld + 16 * jj) * sizeof(bf16));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][2 * jj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * jj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // es and ws are rewritten by the next tile
  }
  cp_async_wait(0);

  float* out = dx_out + (size_t)split * N * D;
  if (d_base < D) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * mi + gq + 8 * h, d = d_base + 8 * n + 2 * tq;
          if (row < N && d < D)
            *reinterpret_cast<float2*>(out + (size_t)row * D + d) =
                make_float2(acc[mi][n][2 * h], acc[mi][n][2 * h + 1]);
        }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dt_acc += __shfl_xor_sync(0xffffffffu, dt_acc, off);
  if (lane == 0) red[warp] = dt_acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < T_THREADS / 32; ++i) sum += red[i];
    dt_part[blockIdx.x * splits + split] = sum;
  }
}

// ---- pass 3 ----

// dx = the partial dx summed in split order, four floats a thread
__global__ void vq_bwd_reduce_kernel(const float4* __restrict__ part, int splits, size_t n4,
                                     float4* __restrict__ dx) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[(size_t)s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  dx[i] = a;
}

__global__ void vq_bwd_dt_kernel(const float* __restrict__ part, int n, float* __restrict__ dt) {
  float sum = 0.f;
  for (int i = 0; i < n; ++i) sum += part[i];
  dt[0] = sum;
}

cudaError_t launch_vq_bwd(int is_bf16, const void* x, const void* g, const void* en,
                          const float* norms, const int* mask, int N, int V, int D, float t,
                          int splits, float* stats, float* dx_part, float* dt_part, float* dx,
                          float* dt, cudaStream_t stream) {
  const int rows = is_bf16 ? TR : VR;
  const int col_tiles = (V + VC - 1) / VC, row_tiles = (N + rows - 1) / rows;
  const int cols_per_split = (col_tiles + splits - 1) / splits * VC;
  const dim3 grid(row_tiles, splits);
  float* out = splits > 1 ? dx_part : dx;
  const float inv_t = 1.f / t;
  cudaError_t err;
  if (is_bf16) {
    const size_t smem = tc_smem_bytes(D);
    const bf16 *xb = static_cast<const bf16*>(x), *gb = static_cast<const bf16*>(g),
               *eb = static_cast<const bf16*>(en);
    err = cudaFuncSetAttribute(vq_bwd_tc_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(vq_bwd_tc_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    vq_bwd_tc_kernel<false><<<grid, T_THREADS, smem, stream>>>(
        xb, gb, eb, norms, mask, N, V, D, splits, cols_per_split, inv_t, stats, out, dt_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vq_bwd_tc_kernel<true><<<grid, T_THREADS, smem, stream>>>(
        xb, gb, eb, norms, mask, N, V, D, splits, cols_per_split, inv_t, stats, out, dt_part);
  } else {
    const size_t smem = sizeof(float) * VR * D;
    const float *xf = static_cast<const float*>(x), *gf = static_cast<const float*>(g),
                *ef = static_cast<const float*>(en);
    err = cudaFuncSetAttribute(vq_bwd_fma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    vq_bwd_fma_kernel<false><<<grid, V_THREADS, 0, stream>>>(
        xf, gf, ef, norms, mask, N, V, D, splits, cols_per_split, inv_t, stats, out, dt_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vq_bwd_fma_kernel<true><<<grid, V_THREADS, smem, stream>>>(
        xf, gf, ef, norms, mask, N, V, D, splits, cols_per_split, inv_t, stats, out, dt_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t n4 = (size_t)N * D / 4;
    vq_bwd_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dx_part), splits, n4, reinterpret_cast<float4*>(dx));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  vq_bwd_dt_kernel<<<1, 1, 0, stream>>>(dt_part, row_tiles * splits, dt);
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

// Straight-through backward. x, g (N, D) and en (V, D) in the compute dtype
// (is_bf16), row-major, 16-byte aligned, D a multiple of 16 (at most 512 in
// bf16, 1024 in fp32); norms (V,) fp32 = ||emb||, mask (V,) int32, t the
// temperature. rows (64 in bf16, 32 in fp32) and splits come from the
// wrapper's plan. Scratch: stats 3 * splits * N fp32, dx_part splits * N * D
// fp32 (unused, may be null, when splits == 1), dt_part ceil(N / rows) *
// splits fp32. Outputs: dx (N, D) fp32, dt (1,) fp32. Returns a cudaError_t.
int sc_vq_bwd(const void* x, const void* g, const void* en, const float* norms,
              const int* mask, int N, int V, int D, float t, int is_bf16, int rows, int splits,
              float* stats, float* dx_part, float* dt_part, float* dx, float* dt,
              cudaStream_t stream) {
  const int col_tiles = V > 0 ? (V + VC - 1) / VC : 0;
  if (N <= 0 || V <= 0 || D <= 0 || D % 16 || D > (is_bf16 ? T_DMAX : 1024) || !(t > 0.f) ||
      rows != (is_bf16 ? TR : VR) || splits < 1 || splits > col_tiles ||
      (splits > 1 && dx_part == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_vq_bwd(is_bf16, x, g, en, norms, mask, N, V, D, t, splits, stats, dx_part,
                            dt_part, dx, dt, stream);
}

// x (N, D), en (V, D): fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), row-major.
// mask (V,) int32, nonzero = excluded column. Scratch: part_f 4*splits*N
// floats, part_i splits*N ints, col_part chunks*V floats. Outputs: k (N,)
// int32, ent/m/z (N,) fp32, psum (V,) fp32. Returns a cudaError_t.
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
