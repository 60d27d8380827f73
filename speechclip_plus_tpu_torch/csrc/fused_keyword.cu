// Fused cosine-score -> VQ statistics, forward (K3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// speechclip_plus_tpu/ops/fused_keyword.py:92 (launched by
// `_pallas_fwd_call`, :178, from `fused_cosine_vq`, :290). For N keyword
// rows x (N, D) against the normalized codebook en (V, D) it computes the
// masked scores s = x . en^T and, per row, the argmax k (ties to the lowest
// index, as jnp.argmax), the entropy ent = log z - sum e (s - m) / z, and the
// column sums psum[v] = sum_rows softmax(s)[v]. Masked columns (CLIP special
// ids) score -1e30: they never win and add 0 to every sum.
//
// What bounds it on the H100. The function is one N x D x V product (80
// GFLOP at N = 9600, D = 512, V = 8112) against a few MB of traffic, so it
// is bound by operations. The TPU held the table resident in VMEM and
// carried psum from one grid step to the next; a block here cannot hold the
// 8 MB bf16 table and blocks run in no order, so the work is two passes over
// a grid of (row tiles, V splits) that the wrapper's plan chooses
// (`_fwd_plan`) so that every row count fills the card's 132 SMs; split k
// owns the whole column tiles [k * cols_per_split, (k + 1) * cols_per_split):
//
//   1. pass 1 (vq_fwd_tc_kernel<rows, false>, fp32: vq_rows_kernel): each
//      block keeps, per row, the running (m, z = sum e, w = sum e s, best
//      value, best index) over its split's columns and writes them per split;
//   2. vq_combine_kernel merges the splits in column order -> k, ent, m, z;
//   3. pass 2 (vq_fwd_tc_kernel<rows, true>, fp32: vq_cols_kernel): each block
//      forms its scores again and sums exp(s - m) / z over its rows, one
//      partial per (row tile, column);
//   4. vq_reduce_kernel sums the partials in row-tile order.
//
// Steps 1-2 are one entry point (sc_vq_fwd_rows) and steps 3-4 another
// (sc_vq_fwd_cols). Under tensor parallelism each rank holds a vocabulary
// shard: step 2 writes the shard's merged row statistics instead of k, the
// ranks gather them in column order, vq_combine_kernel merges them again
// with one "split" a shard (sc_vq_combine; its strict > keeps the lowest
// global index, as the unsharded argmax does), and steps 3-4 run on the
// shard's columns from the global (m, z): psum stays the shard's.
//
// No (N, V) tensor reaches device memory and no float atomics are used, so
// reruns give identical statistics. In bf16 the scores run on the tensor
// cores (`mma.sync` m16n8k16, bf16 operands, fp32 accumulators: the products
// are exact, as on the MXU; only the order of the sums differs); fp32 keeps
// an FMA tile on the same grid.
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
// GFLOP at N = 9600, D = 512, V = 8112; 598 at D = 768) against a few MB of
// traffic, so it is bound by operations, and no (N, V) tensor reaches device
// memory. In bf16
// the products run on the tensor cores as K3's do; fp32 keeps an FMA tile.
// The grid is (row tiles, V splits), the split count chosen by the wrapper
// (`_bwd_plan`); the passes are described at K3b's code. g and dz / t are
// rounded to the compute dtype before their products, as on the TPU (:139,
// :146-149). No float atomics: reruns are bit-identical. No codebook
// gradient: the table is frozen (the wrapper enforces it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "numeric.cuh"

namespace {

constexpr int VR = 32;          // rows per FMA score tile
constexpr int VC = 64;          // columns per FMA score tile
constexpr int VD = 64;          // D chunk staged in shared memory
constexpr int V_THREADS = 256;  // thread (ty, tx): rows ty*2+i (i<2), cols tx+16j (j<4)
constexpr int TPAD = 8;         // bf16 padding of a shared row (16 bytes)
constexpr float INIT_MAX = -3e38f;

// Softmax statistics of a column set are kept as (m, z = sum e, w = sum e s),
// e = exp(s - m): a rescale multiplies z and w alike, and the entropy is
// log z - sum e (s - m) / z = log z + m - w / z. Merge two sets; an empty
// set (INIT_MAX, 0, 0) merges as the identity.
__device__ __forceinline__ void merge_mzw(float& m, float& z, float& w, float m2, float z2,
                                          float w2) {
  const float mn = fmaxf(m, m2);
  const float a = expf(m - mn), b = expf(m2 - mn);
  z = a * z + b * z2;
  w = a * w + b * w2;
  m = mn;
}

// 2^x in one MUFU.EX2 (a few ulp; 0 for -inf and below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (bv, bi) <- the better of itself and (bv2, bi2): the larger value, the
// lower index on a tie. bi = -1 (no column) comes only with bv = INIT_MAX.
__device__ __forceinline__ void merge_best(float& bv, int& bi, float bv2, int bi2) {
  if (bv2 > bv || (bv2 == bv && bi2 < bi)) {
    bv = bv2;
    bi = bi2;
  }
}

// ---- fp32: the FMA tile (32 rows x 64 columns, 256 threads) ----

// s[i][j] = x[r0 + ty*2 + i] . en[c0 + tx + 16 j], zero outside N / V.
// Starts with a barrier, so consecutive calls may reuse the staging buffers.
__device__ __forceinline__ void score_tile(
    const float* __restrict__ x, const float* __restrict__ en, int N, int V, int D,
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
      xs[r][d] = (gr < N && gd < D) ? x[(size_t)gr * D + gd] : 0.f;
    }
    for (int e = tid; e < VC * VD; e += V_THREADS) {
      const int c = e / VD, d = e % VD, gc = c0 + c, gd = d0 + d;
      es[c][d] = (gc < V && gd < D) ? en[(size_t)gc * D + gd] : 0.f;
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

// pass 1, fp32: block (32 rows, one split)
__global__ void __launch_bounds__(V_THREADS) vq_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ en, const int* __restrict__ mask,
    int N, int V, int D, int cols_per_split, float* __restrict__ stats,
    int* __restrict__ best_i) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * VR, split = blockIdx.y;
  const int cbeg = split * cols_per_split;
  const int cend = min(V, cbeg + cols_per_split);
  float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, w[2] = {0.f, 0.f};
  float bv[2] = {INIT_MAX, INIT_MAX};
  int bi[2] = {-1, -1};

  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    float s[2][4];
    score_tile(x, en, N, V, D, r0, c0, xs, es, s);
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      live[j] = c < cend && !mask[c];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tm = INIT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
        tm = fmaxf(tm, s[i][j]);
        if (s[i][j] > bv[i]) {  // columns rise with j: strict > keeps the lowest
          bv[i] = s[i][j];
          bi[i] = c0 + tx + 16 * j;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      float te = 0.f, tw = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
        const float e = expf(s[i][j] - tm);
        te += e;
        tw += e * s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        te += __shfl_xor_sync(0xffffffffu, te, off);
        tw += __shfl_xor_sync(0xffffffffu, tw, off);
      }
      merge_mzw(m[i], z[i], w[i], tm, te, tw);
    }
  }

  const size_t sn = (size_t)gridDim.y * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      merge_best(bv[i], bi[i], __shfl_xor_sync(0xffffffffu, bv[i], off),
                 __shfl_xor_sync(0xffffffffu, bi[i], off));
    const int row = r0 + ty * 2 + i;
    if (tx == 0 && row < N) {
      const size_t o = (size_t)split * N + row;
      stats[o] = m[i];
      stats[sn + o] = z[i];
      stats[2 * sn + o] = w[i];
      stats[3 * sn + o] = bv[i];
      best_i[o] = bi[i];
    }
  }
}

// pass 2, fp32: block (32 rows, one split) -> col_part[row tile][its columns]
__global__ void __launch_bounds__(V_THREADS) vq_cols_kernel(
    const float* __restrict__ x, const float* __restrict__ en, const int* __restrict__ mask,
    const float* __restrict__ m_row, const float* __restrict__ z_row, int N, int V, int D,
    int cols_per_split, float* __restrict__ col_part) {
  __shared__ float xs[VR][VD + 1];
  __shared__ float es[VC][VD + 1];
  __shared__ float red[16][VC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * VR, split = blockIdx.y;
  const int cbeg = split * cols_per_split, cend = min(V, cbeg + cols_per_split);
  float mr[2], iz[2];  // rows past N: p = exp(0 - 0) * 0 = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty * 2 + i;
    mr[i] = row < N ? m_row[row] : 0.f;
    iz[i] = row < N ? 1.f / z_row[row] : 0.f;
  }
  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    float s[2][4];
    score_tile(x, en, N, V, D, r0, c0, xs, es, s);  // its first barrier: red is read
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      float acc = 0.f;
      if (c < cend && !mask[c]) acc = expf(s[0][j] - mr[0]) * iz[0] + expf(s[1][j] - mr[1]) * iz[1];
      red[ty][tx + 16 * j] = acc;
    }
    __syncthreads();
    if (tid < VC && c0 + tid < cend) {
      float sum = 0.f;
      for (int g = 0; g < 16; ++g) sum += red[g][tid];
      col_part[(size_t)blockIdx.x * V + c0 + tid] = sum;
    }
  }
}

// ---- bf16: the tensor-core tile (ROWS rows x 128 columns, ROWS / 8 warps) ----
//
// The block keeps its ROWS x rows resident in shared memory (bf16 rows padded
// by 16 bytes, so that the 8 row addresses of an `ldmatrix` fall on distinct
// banks for any D % 16 = 0) and streams its split's codebook through a ring
// of stages, each 128 columns x 64 values of D, by `cp.async`: one commit
// group a stage, all but one in flight under the products, one barrier a
// stage. The ring runs on across column tiles, so the next tile's first
// stages arrive under the current tile's last products and epilogue. Warp
// (wr, wc) forms the 32 x 32 block of s at rows 32 wr.. and columns 32 wc..
// of the tile by `ldmatrix` + `mma.sync` m16n8k16 (2 A and 2 B
// `ldmatrix.x4` feed 8 products a k-step), accumulated in fp32 over D.
//
// Every block reads its split's whole codebook from L2, so the L2 traffic is
// (N / ROWS) x 8.3 MB a pass: 128 rows halve it where the x rows fit (D <=
// 512: 217 KB, one block of 16 warps an SM); 64 rows otherwise (D <= 768,
// 178 KB, one block of 8 warps). The tile epilogues' exponentials are
// `ex2.approx` of one FFMA (a few ulp, far inside the checks).

constexpr int FC = 128;             // columns per tile
constexpr int FK = 64;              // D values per ring stage
constexpr int F_STAGES = 4;
constexpr int F_DMAX = 768;
constexpr int F_DMAX_128 = 512;     // widest D of the 128-row tile
constexpr int FLD = FK + TPAD;      // row stride of a ring stage
constexpr int F_STATS = 5;          // pass 1's per-row statistics in shared memory
constexpr float LOG2E = 1.4426950408889634f;

size_t fwd_tc_smem_bytes(int rows, int D) {
  return sizeof(bf16) * ((size_t)rows * (D + TPAD) + (size_t)F_STAGES * FC * FLD) +
         sizeof(float) * 4 * rows * F_STATS;
}

// pass 1 (PSUM = false): stats [4][splits][N] = the split's (m, z, w, best
// value) per row, best_i [splits][N]. pass 2 (PSUM = true): col_part[row
// tile][c] = sum over the block's rows of exp(s - m) / z, from the combined
// m_row and z_row.
template <int ROWS, bool PSUM>
__global__ void __launch_bounds__(ROWS * 4, 1) vq_fwd_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ en, const int* __restrict__ mask,
    int N, int V, int D, int cols_per_split, float* __restrict__ stats,
    int* __restrict__ best_i, const float* __restrict__ m_row, const float* __restrict__ z_row,
    float* __restrict__ col_part) {
  constexpr int THREADS = ROWS * 4, RG = ROWS / 32;  // RG row groups of 32 rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + TPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = xs + ROWS * ld;
  float* red = reinterpret_cast<float*>(ring + F_STAGES * FC * FLD);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;  // rows 32 wr.., columns 32 wc.. of a tile
  const int r0 = blockIdx.x * ROWS, split = blockIdx.y;
  const int cbeg = split * cols_per_split, cend = min(V, cbeg + cols_per_split);
  const int chunks = (D + FK - 1) / FK;
  const int total = cend > cbeg ? (cend - cbeg + FC - 1) / FC * chunks : 0;

  // x rows, zeros past N: one commit group, which the first wait covers
  const int xw = D / 8;  // 16-byte pieces a row
  for (int e = tid; e < ROWS * xw; e += THREADS) {
    const int r = e / xw, ck = e % xw;
    const bool in = r0 + r < N;
    cp_async16(smem_u32(xs + r * ld + ck * 8), x + (size_t)(in ? r0 + r : 0) * D + ck * 8, in);
  }
  cp_async_commit();
  // stage g: columns [c0, c0 + 128) x D values [d0, d0 + 64) of en, zeros
  // from cend on; always one commit group, empty past the last stage
  auto load_stage = [&](int g) {
    if (g < total) {
      const int c0 = cbeg + g / chunks * FC, d0 = g % chunks * FK;
      const int w = min(FK, D - d0) / 8;
      bf16* dst = ring + (g % F_STAGES) * FC * FLD;
      for (int e = tid; e < FC * w; e += THREADS) {
        const int r = e / w, ck = e % w, c = c0 + r;
        const bool in = c < cend;
        cp_async16(smem_u32(dst + r * FLD + ck * 8), en + (size_t)(in ? c : 0) * D + d0 + ck * 8,
                   in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < F_STAGES - 1; ++g) load_stage(g);

  if (PSUM && tid < ROWS) {  // -m log2 e and 1 / z of the rows, read after the first barrier
    const bool in = r0 + tid < N;  // rows past N: 2^(0 - 0) * 0 = 0
    red[tid] = in ? -m_row[r0 + tid] * LOG2E : 0.f;
    red[ROWS + tid] = in ? 1.f / z_row[r0 + tid] : 0.f;
  }
  float* colred = red + 2 * ROWS;  // pass 2: [RG][FC] column sums of the row groups

  const uint32_t x_at = smem_u32(xs + (32 * wr + (lane & 15)) * ld + (lane >> 4) * 8);
  const uint32_t e_off =
      ((32 * wc + (lane & 7) + ((lane >> 4) << 3)) * FLD + ((lane >> 3) & 1) * 8) * sizeof(bf16);
  const uint32_t ring_at = smem_u32(ring);

  // pass 1: rows 32 wr + 16 mi + 8 h + gq, r4 = 2 mi + h: the running
  // (m, -m log2 e, z, w) over the thread's columns, and the best (value, index)
  float m[4], nml[4], z[4], w[4], bv[4];
  int bi[4];
#pragma unroll
  for (int r4 = 0; r4 < 4; ++r4) {
    m[r4] = bv[r4] = INIT_MAX;
    nml[r4] = z[r4] = w[r4] = 0.f;
    bi[r4] = -1;
  }
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int g = 0; g < total; ++g) {
    cp_async_wait(F_STAGES - 2);
    __syncthreads();  // stage g has landed; stage g - 1's slot is free
    load_stage(g + F_STAGES - 1);
    const int kc = g % chunks, d0 = kc * FK, ksteps = min(FK, D - d0) / 16;
    const uint32_t e_at = ring_at + (g % F_STAGES) * FC * FLD * sizeof(bf16) + e_off;
#pragma unroll
    for (int ks = 0; ks < FK / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], x_at + (mi * 16 * ld + d0 + ks * 16) * sizeof(bf16));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4(b[jj], e_at + (jj * 16 * FLD + ks * 16) * sizeof(bf16));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(acc[mi][2 * jj], a[mi], b[jj][0], b[jj][1]);
          mma_bf16(acc[mi][2 * jj + 1], a[mi], b[jj][2], b[jj][3]);
        }
    }
    if (kc != chunks - 1) continue;

    // the tile's epilogue: thread columns c0 + 32 wc + 8 j + 2 tq + e, rising with (j, e)
    const int c0 = cbeg + g / chunks * FC;
    const int cw = c0 + 32 * wc + 2 * tq;
    bool live[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cw + 8 * j + e;
        live[j][e] = c < cend && !__ldg(mask + c);
      }
    if (!PSUM) {
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int mi = r4 >> 1, h = r4 & 1;
        float v[4][2], tm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[j][e] = live[j][e] ? acc[mi][j][2 * h + e] : -INFINITY;
            tm = fmaxf(tm, v[j][e]);
          }
        if (tm > bv[r4]) {  // a new best: the tile's lowest column at tm (strict >
          bv[r4] = tm;      // keeps an earlier tile's on a tie)
#pragma unroll
          for (int j = 3; j >= 0; --j)
#pragma unroll
            for (int e = 1; e >= 0; --e)
              if (v[j][e] == tm) bi[r4] = cw + 8 * j + e;
        }
        if (tm > m[r4]) {  // rescale z and w to the new maximum
          const float a = ex2((m[r4] - tm) * LOG2E);
          z[r4] *= a;
          w[r4] *= a;
          m[r4] = tm;
          nml[r4] = -tm * LOG2E;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ee = ex2(fmaf(v[j][e], LOG2E, nml[r4]));  // 0 on a dead column
            z[r4] += ee;
            w[r4] = fmaf(ee, acc[mi][j][2 * h + e], w[r4]);
          }
      }
    } else {
      float nm[4], iz[4];
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int row = 32 * wr + 16 * (r4 >> 1) + 8 * (r4 & 1) + gq;
        nm[r4] = red[row];
        iz[r4] = red[ROWS + row];
      }
      float cs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4)
            sum = fmaf(ex2(fmaf(acc[r4 >> 1][j][2 * (r4 & 1) + e], LOG2E, nm[r4])), iz[r4], sum);
          // the warp's 32 rows: the 8 lanes of a column, in a fixed order
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          cs[j][e] = live[j][e] ? sum : 0.f;
        }
      if (gq == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(colred + wr * FC + 32 * wc + 8 * j + 2 * tq) =
              make_float2(cs[j][0], cs[j][1]);
      }
      __syncthreads();  // colred complete; it is rewritten after the next stage's barrier
      if (tid < FC && c0 + tid < cend) {
        float sum = colred[tid];
#pragma unroll
        for (int q = 1; q < RG; ++q) sum += colred[q * FC + tid];
        col_part[(size_t)blockIdx.x * V + c0 + tid] = sum;
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  }
  cp_async_wait(0);
  if (PSUM) return;

  // the quad's four column sets, then the four column warps of a row, in order
#pragma unroll
  for (int r4 = 0; r4 < 4; ++r4) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r4], off);
      const float z2 = __shfl_xor_sync(0xffffffffu, z[r4], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, w[r4], off);
      merge_mzw(m[r4], z[r4], w[r4], m2, z2, w2);
      merge_best(bv[r4], bi[r4], __shfl_xor_sync(0xffffffffu, bv[r4], off),
                 __shfl_xor_sync(0xffffffffu, bi[r4], off));
    }
    if (tq == 0) {
      float* o = red + (wc * ROWS + 32 * wr + 16 * (r4 >> 1) + 8 * (r4 & 1) + gq) * F_STATS;
      o[0] = m[r4];
      o[1] = z[r4];
      o[2] = w[r4];
      o[3] = bv[r4];
      o[4] = __int_as_float(bi[r4]);
    }
  }
  __syncthreads();
  if (tid < ROWS && r0 + tid < N) {
    const float* a = red + tid * F_STATS;
    float mm = a[0], zz = a[1], ww = a[2], bb = a[3];
    int ii = __float_as_int(a[4]);
    for (int q = 1; q < 4; ++q) {
      const float* b = red + (q * ROWS + tid) * F_STATS;
      merge_mzw(mm, zz, ww, b[0], b[1], b[2]);
      merge_best(bb, ii, b[3], __float_as_int(b[4]));
    }
    const size_t sn = (size_t)gridDim.y * N, o = (size_t)split * N + r0 + tid;
    stats[o] = mm;
    stats[sn + o] = zz;
    stats[2 * sn + o] = ww;
    stats[3 * sn + o] = bb;
    best_i[o] = ii;
  }
}

// the splits merged in column order: strict > keeps the lowest index. The
// loads of 8 splits are issued together ahead of their merges. Writes k, ent,
// m and z where k is given, and where row_stats is given the merged row
// [4][N] (m, z, w, best value) with its best index + index_offset in row_best
// (-1 where no split had a live column): a tensor-parallel vocabulary shard's
// statistics, which this kernel merges again across the shards (splits = tp).
__global__ void vq_combine_kernel(const float* __restrict__ stats, const int* __restrict__ best_i,
                                  int N, int splits, int* __restrict__ k,
                                  float* __restrict__ ent, float* __restrict__ m_out,
                                  float* __restrict__ z_out, float* __restrict__ row_stats,
                                  int* __restrict__ row_best, int index_offset) {
  constexpr int B = 8;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t sn = (size_t)splits * N;
  float m = INIT_MAX, z = 0.f, w = 0.f, bv = INIT_MAX;
  int bi = 0;
  bool found = false;
  for (int s0 = 0; s0 < splits; s0 += B) {
    float pm[B], pz[B], pw[B], pb[B];
    int pi[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const size_t o = (size_t)min(s0 + q, splits - 1) * N + row;
      pm[q] = stats[o];
      pz[q] = stats[sn + o];
      pw[q] = stats[2 * sn + o];
      pb[q] = stats[3 * sn + o];
      pi[q] = best_i[o];
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      if (s0 + q >= splits) break;
      merge_mzw(m, z, w, pm[q], pz[q], pw[q]);
      if (pi[q] >= 0 && pb[q] > bv) {
        bv = pb[q];
        bi = pi[q];
        found = true;
      }
    }
  }
  if (k != nullptr) {
    k[row] = bi;
    ent[row] = logf(z) + m - w / z;
    m_out[row] = m;
    z_out[row] = z;
  }
  if (row_stats != nullptr) {
    row_stats[row] = m;
    row_stats[N + row] = z;
    row_stats[2 * (size_t)N + row] = w;
    row_stats[3 * (size_t)N + row] = bv;
    row_best[row] = found ? bi + index_offset : -1;
  }
}

// psum = the (row tile, column) partials summed in row-tile order
__global__ void vq_reduce_kernel(const float* __restrict__ col_part, int row_tiles, int V,
                                 float* __restrict__ psum) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= V) return;
  float sum = 0.f;
  for (int i = 0; i < row_tiles; ++i) sum += col_part[(size_t)i * V + c];
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

// 1 / t from the temperature in device memory, rounded as the host's fp32
// division would round it (IEEE division: the build has no fast-math); NaN
// for a temperature that is not positive.
__device__ __forceinline__ float inverse_temperature(const float* __restrict__ temp) {
  const float t = __ldg(temp);
  return t > 0.f ? 1.f / t : __int_as_float(0x7fc00000);
}

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
    int splits, int n_stats, int cols_per_split, const float* __restrict__ temp,
    float* __restrict__ stats, float* __restrict__ dx_out, float* __restrict__ dt_part) {
  const float inv_t = inverse_temperature(temp);
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
  if (tid < VR) merged_row(stats, n_stats, N, r0 + tid, rowst[tid]);
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

// ---- bf16: the tensor-core tile (64 or 32 rows, 8 warps, mma.sync m16n8k16) ----
//
// The block keeps its x and g rows and one 64-column tile of en in shared
// memory (bf16 rows padded by 16 bytes, so that the 8 row addresses of an
// `ldmatrix` fall on distinct banks). Up to D = 512 a block owns 64 rows
// (208 KB at D = 512: one block an SM); beyond, 32 rows (201 KB at D = 768,
// the large family's CLIP width), since 64 rows of x and g at 768 alone take
// 194 KB. Warp (rg, ch) forms s = x . en^T and u = g . en^T for rows 16 rg..
// and columns WC ch.. of the tile (64 rows: 4 x 2 warps of 32 columns; 32
// rows: 2 x 4 warps of 16), reading x, g and en by `ldmatrix`; pass 2 rounds
// w = dz / t to bf16 into a (rows, 64) shared tile, and warp k multiplies all
// rows of w by columns [DC k, DC (k + 1)) of the same en tile
// (`ldmatrix.trans`: en is the B operand as it lies), keeping that part of dx
// in registers for the whole split: DC = 64 columns over 64 rows, or 96 over
// 32 rows, 128 or 96 registers a thread.

constexpr int T_THREADS = 256;
constexpr int T_DMAX = 768;     // the widest D of the 32-row tile
constexpr int T_DMAX_64 = 512;  // the widest D of the 64-row tile
constexpr int WLD = VC + TPAD;  // row stride of the w tile

// the tile's shapes for ROWS rows: row groups of 16, warps a row group in
// the s / u tile, its columns a warp, and dx columns a warp
template <int ROWS>
struct TcTile {
  static constexpr int RG = ROWS / 16, CH = 8 / RG, WC = VC / CH, NJ = WC / 8;
  static constexpr int DC = (ROWS == 64 ? T_DMAX_64 : T_DMAX) / 8;
};

size_t tc_smem_bytes(int rows, int D) {
  return sizeof(bf16) * ((size_t)(2 * rows + VC) * (D + TPAD) + (size_t)rows * WLD) +
         sizeof(float) * (2 * VC + 8 * 16 * 3 + T_THREADS / 32);
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

// s and u of the warp's 16 rows and NJ x 8 columns: waits for the en tile's
// groups one by one, so that the later quarters of D arrive under the
// products of the earlier ones. x_at, g_at and e_at are the lane's ldmatrix
// addresses at k = 0. Its first barrier also publishes the tile's flags.
template <int NJ>
__device__ __forceinline__ void su_tile(uint32_t x_at, uint32_t g_at, uint32_t e_at, int D,
                                        int ld, float (&s)[NJ][4], float (&u)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
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
      for (int jj = 0; jj < NJ / 2; ++jj) {
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

template <int ROWS, bool DX>
__global__ void __launch_bounds__(T_THREADS, 1) vq_bwd_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ en,
    const float* __restrict__ norms, const int* __restrict__ mask, int N, int V, int D,
    int splits, int n_stats, int cols_per_split, const float* __restrict__ temp,
    float* __restrict__ stats, float* __restrict__ dx_out, float* __restrict__ dt_part) {
  const float inv_t = inverse_temperature(temp);
  using Tile = TcTile<ROWS>;
  constexpr int RG = Tile::RG, CH = Tile::CH, WC = Tile::WC, NJ = Tile::NJ, DC = Tile::DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + TPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + ROWS * ld;
  bf16* es = gs + ROWS * ld;
  bf16* ws = es + VC * ld;
  float* nrm = reinterpret_cast<float*>(ws + ROWS * WLD);
  int* live = reinterpret_cast<int*>(nrm + VC);
  float* rowst = reinterpret_cast<float*>(live + VC);  // [CH][ROWS][3]
  float* red = rowst + CH * ROWS * 3;                  // [T_THREADS / 32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp % RG, ch = warp / RG;  // s and u: rows 16 rg.., columns WC ch..
  const int r0 = blockIdx.x * ROWS, split = blockIdx.y;
  const int cbeg = split * cols_per_split, cend = min(V, cbeg + cols_per_split);

  // x and g rows, zeros past N: one commit group, which the first tile's
  // first wait covers
  const int chunks = D / 8;
  for (int e = tid; e < ROWS * chunks; e += T_THREADS) {
    const int r = e / chunks, ck = e % chunks;
    const bool in = r0 + r < N;
    const size_t o = (size_t)(in ? r0 + r : 0) * D + ck * 8;
    cp_async16(smem_u32(xs + r * ld + ck * 8), x + o, in);
    cp_async16(smem_u32(gs + r * ld + ck * 8), g + o, in);
  }
  cp_async_commit();
  const uint32_t x_at = smem_u32(xs + (16 * rg + (lane & 15)) * ld + (lane >> 4) * 8);
  const uint32_t g_at = x_at + ROWS * ld * sizeof(bf16);
  const uint32_t e_at =
      smem_u32(es + (WC * ch + (lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);

  if (!DX) {
    float m[2] = {INIT_MAX, INIT_MAX}, z[2] = {0.f, 0.f}, zu[2] = {0.f, 0.f};
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      load_en_tile(es, nrm, live, en, norms, mask, cend, D, ld, c0);
      float s[NJ][4], u[NJ][4];
      su_tile<NJ>(x_at, g_at, e_at, D, ld, s, u);
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows gq + 8 i: accumulator entries 2 i, 2 i + 1
        float tm = INIT_MAX;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (live[WC * ch + 8 * j + 2 * tq + e]) tm = fmaxf(tm, s[j][2 * i + e] * inv_t);
        float te = 0.f, tu = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = WC * ch + 8 * j + 2 * tq + e;
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
    // the quad's four column sets, then the CH warps of a row group in order
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
        float* o = rowst + (ch * ROWS + 16 * rg + gq + 8 * i) * 3;
        o[0] = m[i];
        o[1] = z[i];
        o[2] = zu[i];
      }
    }
    __syncthreads();
    if (tid < ROWS && r0 + tid < N) {
      const float* a = rowst + tid * 3;
      float mm = a[0], zz = a[1], zzu = a[2];
#pragma unroll
      for (int c = 1; c < CH; ++c) {
        const float* b = rowst + (c * ROWS + tid) * 3;
        merge_ezu(mm, zz, zzu, b[0], b[1], b[2]);
      }
      const size_t sn = (size_t)splits * N, o = (size_t)split * N + r0 + tid;
      stats[o] = mm;
      stats[sn + o] = zz;
      stats[2 * sn + o] = zzu;
    }
    return;
  }

  if (tid < ROWS) merged_row(stats, n_stats, N, r0 + tid, rowst + tid * 3);  // read after a barrier
  float acc[RG][DC / 8][4];  // dx: rows 16 mi + .., columns DC warp + 8 n + ..
#pragma unroll
  for (int mi = 0; mi < RG; ++mi)
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
  float dt_acc = 0.f;
  const int d_base = DC * warp;
  const uint32_t w_at = smem_u32(ws + (lane & 15) * WLD + (lane >> 4) * 8);
  const uint32_t et_at =
      smem_u32(es + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + d_base + (lane >> 4) * 8);
  for (int c0 = cbeg; c0 < cend; c0 += VC) {
    load_en_tile(es, nrm, live, en, norms, mask, cend, D, ld, c0);
    float s[NJ][4], u[NJ][4];
    su_tile<NJ>(x_at, g_at, e_at, D, ld, s, u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * rg + gq + 8 * i;
      const float mr = rowst[row * 3], iz = rowst[row * 3 + 1], rho = rowst[row * 3 + 2];
      const bool row_ok = r0 + row < N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = WC * ch + 8 * j + 2 * tq;
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
        uint32_t a[RG][4];
#pragma unroll
        for (int mi = 0; mi < RG; ++mi)
          ldsm_x4(a[mi], w_at + (mi * 16 * WLD + ks * 16) * sizeof(bf16));
#pragma unroll
        for (int jj = 0; jj < DC / 16; ++jj) {
          if (d_base + 16 * jj >= D) continue;
          uint32_t b[4];
          ldsm_x4_trans(b, et_at + (ks * 16 * ld + 16 * jj) * sizeof(bf16));
#pragma unroll
          for (int mi = 0; mi < RG; ++mi) {
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
    for (int mi = 0; mi < RG; ++mi)
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
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

// passes: 1 = pass 1, 2 = pass 2, 3 = both
template <int ROWS>
cudaError_t launch_vq_bwd_tc(const bf16* x, const bf16* g, const bf16* en, const float* norms,
                             const int* mask, int N, int V, int D, const dim3 grid, int splits,
                             int n_stats, int cols_per_split, const float* temp, float* stats,
                             float* out, float* dt_part, int passes, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(ROWS, D);
  cudaError_t err = cudaFuncSetAttribute(vq_bwd_tc_kernel<ROWS, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vq_bwd_tc_kernel<ROWS, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (passes & 1) {
    vq_bwd_tc_kernel<ROWS, false><<<grid, T_THREADS, smem, stream>>>(
        x, g, en, norms, mask, N, V, D, splits, n_stats, cols_per_split, temp, stats, out,
        dt_part);
    err = cudaGetLastError();
    if (err != cudaSuccess || !(passes & 2)) return err;
  }
  vq_bwd_tc_kernel<ROWS, true><<<grid, T_THREADS, smem, stream>>>(
      x, g, en, norms, mask, N, V, D, splits, n_stats, cols_per_split, temp, stats, out, dt_part);
  return cudaGetLastError();
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
                          const float* norms, const int* mask, int N, int V, int D,
                          const float* temp, int rows, int splits, int n_stats, int passes,
                          float* stats, float* dx_part, float* dt_part, float* dx, float* dt,
                          cudaStream_t stream) {
  const int col_tiles = (V + VC - 1) / VC, row_tiles = (N + rows - 1) / rows;
  const int cols_per_split = (col_tiles + splits - 1) / splits * VC;
  const dim3 grid(row_tiles, splits);
  float* out = splits > 1 ? dx_part : dx;
  cudaError_t err;
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *gb = static_cast<const bf16*>(g),
               *eb = static_cast<const bf16*>(en);
    err = rows == 64
              ? launch_vq_bwd_tc<64>(xb, gb, eb, norms, mask, N, V, D, grid, splits, n_stats,
                                     cols_per_split, temp, stats, out, dt_part, passes, stream)
              : launch_vq_bwd_tc<32>(xb, gb, eb, norms, mask, N, V, D, grid, splits, n_stats,
                                     cols_per_split, temp, stats, out, dt_part, passes, stream);
    if (err != cudaSuccess || !(passes & 2)) return err;
  } else {
    const size_t smem = sizeof(float) * VR * D;
    const float *xf = static_cast<const float*>(x), *gf = static_cast<const float*>(g),
                *ef = static_cast<const float*>(en);
    err = cudaFuncSetAttribute(vq_bwd_fma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (passes & 1) {
      vq_bwd_fma_kernel<false><<<grid, V_THREADS, 0, stream>>>(
          xf, gf, ef, norms, mask, N, V, D, splits, n_stats, cols_per_split, temp, stats, out,
          dt_part);
      err = cudaGetLastError();
      if (err != cudaSuccess || !(passes & 2)) return err;
    }
    vq_bwd_fma_kernel<true><<<grid, V_THREADS, smem, stream>>>(
        xf, gf, ef, norms, mask, N, V, D, splits, n_stats, cols_per_split, temp, stats, out,
        dt_part);
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

template <int ROWS, bool PSUM>
cudaError_t launch_vq_pass(const bf16* x, const bf16* en, const int* mask, int N, int V, int D,
                           const dim3 grid, int cols_per_split, float* stats, int* best_i,
                           const float* m, const float* z, float* col_part,
                           cudaStream_t stream) {
  const size_t smem = fwd_tc_smem_bytes(ROWS, D);
  cudaError_t err = cudaFuncSetAttribute(vq_fwd_tc_kernel<ROWS, PSUM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  vq_fwd_tc_kernel<ROWS, PSUM><<<grid, ROWS * 4, smem, stream>>>(
      x, en, mask, N, V, D, cols_per_split, stats, best_i, m, z, col_part);
  return cudaGetLastError();
}

struct VqGrid {
  dim3 grid;
  int cols_per_split, row_tiles;
};

VqGrid vq_grid(int is_bf16, int N, int V, int rows, int splits) {
  const int cols = is_bf16 ? FC : VC;
  const int col_tiles = (V + cols - 1) / cols, row_tiles = (N + rows - 1) / rows;
  return {dim3(row_tiles, splits), (col_tiles + splits - 1) / splits * cols, row_tiles};
}

// pass 1 and the combine of the splits
cudaError_t launch_vq_rows(int is_bf16, const void* x, const void* en, const int* mask, int N,
                           int V, int D, int rows, int splits, float* stats, int* best_i, int* k,
                           float* ent, float* m, float* z, float* row_stats, int* row_best,
                           int index_offset, cudaStream_t stream) {
  const VqGrid g = vq_grid(is_bf16, N, V, rows, splits);
  cudaError_t err;
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *eb = static_cast<const bf16*>(en);
    err = rows == 128 ? launch_vq_pass<128, false>(xb, eb, mask, N, V, D, g.grid,
                                                   g.cols_per_split, stats, best_i, nullptr,
                                                   nullptr, nullptr, stream)
                      : launch_vq_pass<64, false>(xb, eb, mask, N, V, D, g.grid,
                                                  g.cols_per_split, stats, best_i, nullptr,
                                                  nullptr, nullptr, stream);
  } else {
    vq_rows_kernel<<<g.grid, V_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(en), mask, N, V, D,
        g.cols_per_split, stats, best_i);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  vq_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(stats, best_i, N, splits, k, ent, m, z,
                                                         row_stats, row_best, index_offset);
  return cudaGetLastError();
}

// pass 2 from the rows' (m, z) and the reduce of its column partials
cudaError_t launch_vq_cols(int is_bf16, const void* x, const void* en, const int* mask, int N,
                           int V, int D, int rows, int splits, const float* m, const float* z,
                           float* col_part, float* psum, cudaStream_t stream) {
  const VqGrid g = vq_grid(is_bf16, N, V, rows, splits);
  cudaError_t err;
  if (is_bf16) {
    const bf16 *xb = static_cast<const bf16*>(x), *eb = static_cast<const bf16*>(en);
    err = rows == 128 ? launch_vq_pass<128, true>(xb, eb, mask, N, V, D, g.grid,
                                                  g.cols_per_split, nullptr, nullptr, m, z,
                                                  col_part, stream)
                      : launch_vq_pass<64, true>(xb, eb, mask, N, V, D, g.grid,
                                                 g.cols_per_split, nullptr, nullptr, m, z,
                                                 col_part, stream);
  } else {
    vq_cols_kernel<<<g.grid, V_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(en), mask, m, z, N, V, D,
        g.cols_per_split, col_part);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  vq_reduce_kernel<<<(V + 127) / 128, 128, 0, stream>>>(col_part, g.row_tiles, V, psum);
  return cudaGetLastError();
}

bool vq_fwd_args_ok(int N, int V, int D, int is_bf16, int rows, int splits) {
  const int cols = is_bf16 ? FC : VC;
  const int col_tiles = V > 0 ? (V + cols - 1) / cols : 0;
  const int want_rows = !is_bf16 ? VR : D <= F_DMAX_128 ? 128 : 64;
  return N > 0 && V > 0 && D > 0 && D % 16 == 0 && D <= (is_bf16 ? F_DMAX : 1024) &&
         rows == want_rows && splits >= 1 && splits <= col_tiles;
}

}  // namespace

extern "C" {

// Straight-through backward. x, g (N, D) and en (V, D) in the compute dtype
// (is_bf16), row-major, 16-byte aligned, D a multiple of 16 (at most 768 in
// bf16, 1024 in fp32); norms (V,) fp32 = ||emb||, mask (V,) int32, temp the
// temperature, one fp32 in device memory that each block reads (a value that
// is not positive gives NaN results). rows (bf16: 64 up to D = 512, else 32; fp32: 32) and splits
// come from the wrapper's plan. Scratch: stats 3 * n_stats * N fp32, dx_part splits * N * D
// fp32 (unused, may be null, when splits == 1), dt_part ceil(N / rows) *
// splits fp32. Outputs: dx (N, D) fp32, dt (1,) fp32. Returns a cudaError_t.
//
// `passes` 3 runs the whole backward (n_stats == splits). On a tensor-parallel
// vocabulary shard en, norms and mask are the shard's, and the call is made
// twice: passes = 1 writes the shard's per-split statistics [3][splits][N]
// into `stats`; the caller gathers those of every shard in column order into
// [3][n_stats][N]; passes = 2 merges all n_stats entries and writes the
// shard's partial dx and dt, which the caller sums over the shards.
int sc_vq_bwd(const void* x, const void* g, const void* en, const float* norms,
              const int* mask, int N, int V, int D, const float* temp, int is_bf16, int rows,
              int splits, float* stats, float* dx_part, float* dt_part, float* dx, float* dt,
              int n_stats, int passes, cudaStream_t stream) {
  const int col_tiles = V > 0 ? (V + VC - 1) / VC : 0;
  const int want_rows = !is_bf16 ? VR : D <= T_DMAX_64 ? 64 : 32;
  if (N <= 0 || V <= 0 || D <= 0 || D % 16 || D > (is_bf16 ? T_DMAX : 1024) ||
      temp == nullptr || rows != want_rows || splits < 1 || splits > col_tiles ||
      (splits > 1 && dx_part == nullptr) || passes < 1 || passes > 3 || n_stats < splits ||
      (passes == 3 && n_stats != splits))
    return (int)cudaErrorInvalidValue;
  return (int)launch_vq_bwd(is_bf16, x, g, en, norms, mask, N, V, D, temp, rows, splits, n_stats,
                            passes, stats, dx_part, dt_part, dx, dt, stream);
}

// Forward, in two entry points that the wrapper calls in turn. x (N, D) and
// en (V, D) in the compute dtype (is_bf16), row-major, 16-byte aligned, D a
// multiple of 16 (at most 768 in bf16, 1024 in fp32); mask (V,) int32,
// nonzero = excluded column. rows (bf16: 128 up to D = 512, else 64; fp32:
// 32) and splits come from the wrapper's plan. Scratch: stats 4 * splits * N
// fp32, best_i splits * N int32, col_part ceil(N / rows) * V fp32.
//
// The rows: pass 1 and the combine of the splits -> k (N,) int32, ent, m, z
// (N,) fp32 where k is not null; where row_stats is not null, the merged
// [4][N] row statistics (m, z, w, best value) and row_best (N,) int32, the
// best column + index_offset (-1 for none). A tensor-parallel vocabulary
// shard (en, mask the shard's, index_offset its first id) writes those; the
// caller gathers every shard's in column order and merges them with
// sc_vq_combine (splits = the shard count) into k, ent, m and z.
int sc_vq_fwd_rows(const void* x, const void* en, const int* mask, int N, int V, int D,
                   int is_bf16, int rows, int splits, float* stats, int* best_i, int* k,
                   float* ent, float* m, float* z, float* row_stats, int* row_best,
                   int index_offset, cudaStream_t stream) {
  if (!vq_fwd_args_ok(N, V, D, is_bf16, rows, splits) ||
      (k == nullptr && row_stats == nullptr) || (row_stats != nullptr && row_best == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_vq_rows(is_bf16, x, en, mask, N, V, D, rows, splits, stats, best_i, k, ent,
                             m, z, row_stats, row_best, index_offset, stream);
}

// The merge alone: stats [4][splits][N] (m, z, w, best value) and best_i
// [splits][N] in column order -> k, ent, m, z (N,).
int sc_vq_combine(const float* stats, const int* best_i, int N, int splits, int* k, float* ent,
                  float* m, float* z, cudaStream_t stream) {
  if (N <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  vq_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(stats, best_i, N, splits, k, ent, m, z,
                                                         nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

// The columns: pass 2 from the rows' m and z (N,) and the reduce -> psum (V,)
// fp32, the column sums of softmax(s) over this codebook (a shard's own).
int sc_vq_fwd_cols(const void* x, const void* en, const int* mask, int N, int V, int D,
                   int is_bf16, int rows, int splits, const float* m, const float* z,
                   float* col_part, float* psum, cudaStream_t stream) {
  if (!vq_fwd_args_ok(N, V, D, is_bf16, rows, splits)) return (int)cudaErrorInvalidValue;
  return (int)launch_vq_cols(is_bf16, x, en, mask, N, V, D, rows, splits, m, z, col_part, psum,
                             stream);
}

}  // extern "C"
