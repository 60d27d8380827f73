// Tensor-core attention for Hopper (sm_90a): the forward kernels and the
// building blocks of the whole attention family. The fused attention block
// (K1, fused_attention_block_attn.cuh), the attention-only kernel with
// in-kernel dropout (K5, fused_attention.cu) and the flash forward with its
// log-sum-exp output (K4, flash.cu) instantiate the forward kernels below;
// the block's backward (K2, attention_bwd.cuh) is built from the same pieces.
//
// Products. Every q k^T, p v (and, in the backward, dctx v^T, ds^T q, ds k)
// product is `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` on fp32
// tiles in shared memory, with fp32 accumulators and fp32 softmax state in
// registers. Where the output is bf16 the operands are rounded to TF32 (as
// cvt.rna does: 10 explicit mantissa bits, against bf16's 7, which the block's
// bf16 tolerance does not allow for q, k, v: PERF.md): an A operand once, as
// its tile is stored or as an accumulator becomes an operand, a B operand as
// its fragment is loaded. Where the output is fp32 (the tests' and the parity
// checks' mode) each operand is split as a = hi + lo with hi = tf32(a),
// lo = tf32(a - hi), and a product is the three passes lo hi + hi lo + hi hi:
// error near 2^-21 relative, so the fp32 checks hold as they did for the fp32
// FMA loops. The same three passes serve q k^T wherever a bf16 output comes
// with the fp32 log-sum-exp (`launch_attention`). bf16 inputs (K4, K5) are
// exact in TF32, and q's scale is applied to the fp32 sums.
//
// Fragments. A thread of a warp is (g, t) = (lane / 4, lane % 4). The A
// operand (16 x 8) holds rows g, g + 8 and columns t, t + 4; the B operand
// (8 x 8) holds k = t, t + 4 and n = g; the accumulator rows g, g + 8 and
// columns 2t, 2t + 1. Operand tiles are row-major fp32 with a row stride of
// 4 mod 32 banks (dh + 4), so that the 32 plain shared loads of a fragment hit
// 32 banks. Where the summed index runs along the rows of a tile (v in p v,
// k in ds k, q and dctx in the backward's second products) the index is
// permuted: operand column t is row 2t and column t + 4 is row 2t + 1. With
// that permutation an accumulator tile (p, ds) IS the A operand of the next
// product, register for register, so p and ds never pass through shared
// memory or shuffles, and the permuted rows 2t, 2t + 1 at a stride of 4 mod 32
// are conflict-free as well: v needs no transpose and no second padding.
//
// Two warp decompositions, one set of pieces.
//   dh <= 128 (`attention_kernel`): a block owns 64 query rows of one (batch,
//   head), 128 at dh = 64, a warp 16 of them with the whole head dim; k and v
//   tiles of 64 keys sit in shared memory whole. Row statistics span the 4
//   lanes of a quad. At dh = 128 (the large branches: 8 heads over 1024) a
//   thread holds 64 output and 32 score accumulators, and a block of 128
//   threads takes (64 + 2 x 64) x 132 x 4 = 101 KB: two blocks an SM.
//   dh = 768 (`attention_wide_kernel`; the cascaded branches run one head over
//   the model width): a (64, 768) tile is 197 KB, so the head dim is cut
//   across the 8 warps, 96 columns each. A warp sums the (32, 32) score tile
//   over its own columns of q and k; the 8 partial tiles are added in a fixed
//   order through shared memory (no atomics), the softmax step runs on the
//   summed tile, and each warp then updates its own 96 columns of the output
//   from its own columns of v. The output accumulator of a 768-wide head is
//   32 rows x 768 fp32 = 96 registers a thread over 256 threads: it lives in
//   registers, because shared memory is spent on what must be shared (the 32
//   query rows, 99 KB; one 32-key tile that holds k, then v, 99 KB; the
//   partial tiles, 32 KB), and a read-modify-write of the accumulator per key
//   tile would double the shared-memory traffic of the p v product. 64 rows
//   fit neither registers nor shared memory.
//   dh = 1024 (the same kernel; the fixed-K large branches run one head over
//   1024): 32 query rows would take 131.6 KB of shared memory, and with the
//   32-key tile (131.6 KB) the block would need 296 KB of the 227 KB an SM
//   has. So the block owns 16 query rows (65.8 KB), keeps the 32-key tile and
//   the 8 partial (16, 32) tiles (16 KB): 214 KB, and each warp's 128 columns
//   of the output are 16 x 128 fp32 = 64 registers a thread. Each key tile
//   then serves half the rows it serves at 768, so the kernel moves twice the
//   L2 traffic per query row: the price of fitting.
//
// What the kernels compute is what the fp32 FMA kernels before them computed:
// online softmax over key tiles; key_bias[b, j] and, when `ab` is given,
// gate[b, h, i] * ab[h, i, j] (fp32 (H | 1, T, T), read from L2); the counter
// dropout mask of dropout_mask.cuh keyed by (row, column) with
// row = (b * H + h) * T + i (H and h of the whole layer: `head_offset` and
// `drop_heads` place a tensor-parallel shard's heads), so every kernel of the family draws the same mask
// from one (seed, offset); o accumulates (mask * e / keep) v while l sums e
// unmasked; lse = m + log(l). q, k, v and the output are addressed by
// (batch, head, row) strides in elements with a contiguous head dim and read
// in place; the ragged T edge is masked here: masked keys carry the caller's
// -1e30, keys past T carry -2e30, never -inf, so a fully padded row stays
// finite. Every output element is summed by one lane in a fixed order: reruns
// are bit-identical. A warp whose rows all lie past T multiplies nothing.
//
// Loads. K and V tiles of fp32 sources (K1, K2) come by `cp.async`, 16 bytes
// a request, a whole tile in flight at once, and lie in shared memory as they
// came: a B fragment is rounded as it is loaded (two integer instructions a
// value; a rounding pass over the tile was measured slower). At dh <= 128 the
// next K tile arrives while the block multiplies p v and the V tile while it
// multiplies q k^T, with no second buffer. bf16 sources (K4, K5, K2's
// cotangent) are widened through registers, 8 loads a thread in flight. TMA,
// wgmma and warp specialisation are later work.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_mask.cuh"
#include "numeric.cuh"

namespace {

constexpr float RAGGED_KEY = -2e30f;  // below the -1e30 padding bias
constexpr float INIT_MAX = -3e38f;
// shared memory of one SM, and what the CUDA runtime reserves per resident block
constexpr size_t SMEM_PER_SM = 233472, SMEM_BLOCK_RESERVE = 1024;

template <size_t BYTES>
constexpr int blocks_per_sm() {
  return (int)(SMEM_PER_SM / (BYTES + SMEM_BLOCK_RESERVE));
}

// ------------------------------------------------------ tensor-core pieces ----

// fp32 -> TF32, round to nearest with ties away from zero: the bits of
// `cvt.rna.tf32.f32`, formed with an integer add and a mask (two full-rate
// instructions; the conversion unit's rate is a quarter of that, and the
// tiles are rounded element by element)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an operand value as the one-pass product takes it, rounded to TF32; the
// three-pass split (P3) takes it untouched
template <bool P3>
__device__ __forceinline__ float op_round(float x) {
  return P3 ? x : __uint_as_float(tf32_bits(x));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b. One pass on operands already rounded to TF32, or (P3) the
// error-compensated three passes on fp32 operands, small terms first. The
// tensor core adds into its accumulator by truncation, which over a long sum
// is a bias of its own size: enough to miss the fp32 checks of the backward
// (1e-4 of sums over every query). So where the output is fp32 (RN) the three
// passes of one 8-deep step are summed from zero and added to c in fp32,
// rounded to nearest.
template <bool P3, bool RN = false>
__device__ __forceinline__ void mma_f(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], bh[2];
  if (P3) {
    uint32_t al[4], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = tf32_bits(a[i]);
      al[i] = tf32_bits(a[i] - __uint_as_float(ah[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bh[i] = tf32_bits(b[i]);
      bl[i] = tf32_bits(b[i] - __uint_as_float(bh[i]));
    }
    if (RN) {
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(step, al, bh);
      mma_tf32(step, ah, bl);
      mma_tf32(step, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] += step[i];
    } else {
      mma_tf32(c, al, bh);
      mma_tf32(c, ah, bl);
      mma_tf32(c, ah, bh);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(a[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) bh[i] = __float_as_uint(b[i]);
    mma_tf32(c, ah, bh);
  }
}

// c += a b where one operand is exact in TF32 (bf16 values) and the other is
// fp32: the fp32 one is split as hi + lo and the product is two passes, as
// exact as the three-pass product. SPLIT_A names the fp32 operand.
template <bool SPLIT_A>
__device__ __forceinline__ void mma_split(float (&c)[4], const float (&a)[4],
                                          const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = SPLIT_A ? tf32_bits(a[i]) : __float_as_uint(a[i]);
    al[i] = tf32_bits(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = SPLIT_A ? __float_as_uint(b[i]) : tf32_bits(b[i]);
    bl[i] = tf32_bits(b[i] - __uint_as_float(bh[i]));
  }
  if (SPLIT_A)
    mma_tf32(c, al, bh);
  else
    mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// A operand of a row-major tile; `s` points at (row g, column t) of the 16 x 8 piece
__device__ __forceinline__ void load_a(float (&a)[4], const float* s, int ld) {
  a[0] = s[0];
  a[1] = s[8 * ld];
  a[2] = s[4];
  a[3] = s[8 * ld + 4];
}

// B operand read from a tile stored [n][k] (its rows are the product's
// columns: k in q k^T); `s` points at (row g, column t). B tiles lie in shared
// memory as they came (`tile_start`), so the fragment is rounded here.
template <bool P3>
__device__ __forceinline__ void load_bt(float (&b)[2], const float* s) {
  b[0] = op_round<P3>(s[0]);
  b[1] = op_round<P3>(s[4]);
}

// B operand read from a tile stored [k][n] with the permuted summed index;
// `s` points at (row 2t, column g)
template <bool P3>
__device__ __forceinline__ void load_bp(float (&b)[2], const float* s, int ld) {
  b[0] = op_round<P3>(s[0]);
  b[1] = op_round<P3>(s[ld]);
}

// an accumulator tile as the A operand of the next product, under the same
// permutation (operand columns t, t + 4 are accumulator columns 2t, 2t + 1)
template <bool P3>
__device__ __forceinline__ void acc_as_a(float (&a)[4], const float (&c)[4]) {
  a[0] = op_round<P3>(c[0]);
  a[1] = op_round<P3>(c[2]);
  a[2] = op_round<P3>(c[1]);
  a[3] = op_round<P3>(c[3]);
}

// 16 bytes of fp32 or bf16 values as floats
__device__ __forceinline__ void unpack16(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&x)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
}

// the largest divisor of n that is at most 8
__host__ __device__ constexpr int load_batch(int n) {
  for (int b = 8; b > 1; --b)
    if (n % b == 0) return b;
  return 1;
}

// Rows [r0, r0 + ROWS) x COLS columns of a (T, row_stride) slice into a
// (ROWS, LD) fp32 operand tile, zero past Tn; rounded to TF32
// on the way unless RAW (an A operand of the one-pass product is rounded
// here, once). `vec`: the source takes 16-byte loads (checked by the
// launcher), else element loads.
// The 16-byte loads are issued in batches of up to 8 a thread before any is
// used, so that a tile costs a few trips to L2 and not one per load.
template <int ROWS, int COLS, int LD, bool RAW, int THREADS, typename T>
__device__ __forceinline__ void fill_tile(float* dst, const T* src, int64_t row_stride, int r0,
                                          int Tn, bool vec) {
  constexpr int V = 16 / sizeof(T), ITERS = ROWS * COLS / V / THREADS, NB = load_batch(ITERS);
  static_assert(ROWS * COLS % (V * THREADS) == 0, "a tile is a whole number of loads a thread");
  if (vec) {
    for (int it = 0; it < ITERS; it += NB) {
      uint4 raw[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = threadIdx.x + (it + i) * THREADS;
        const int r = e / (COLS / V), c = (e % (COLS / V)) * V, t = r0 + r;
        raw[i] = t < Tn ? *reinterpret_cast<const uint4*>(src + t * row_stride + c)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = threadIdx.x + (it + i) * THREADS;
        const int r = e / (COLS / V), c = (e % (COLS / V)) * V;
        float x[V];
        unpack16(raw[i], x);
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(dst + r * LD + c + j) =
              make_float4(op_round<RAW>(x[j]), op_round<RAW>(x[j + 1]), op_round<RAW>(x[j + 2]),
                          op_round<RAW>(x[j + 3]));
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS, t = r0 + r;
      dst[r * LD + c] = t < Tn ? op_round<RAW>(to_f(src[t * row_stride + c])) : 0.f;
    }
  }
}

// A B-operand tile on its way into shared memory in two steps, so that the
// copy runs while the block multiplies another tile. An fp32 source that takes
// 16-byte loads goes by `cp.async`: `tile_start` puts the whole tile in flight
// at once (16 bytes a request, no registers; rows past Tn arrive as zeros) and
// `tile_finish` waits for the thread's own requests. Any other source (bf16,
// odd strides) is loaded in `tile_finish`, through registers. Either way the
// tile holds the values as they came: `load_bt` / `load_bp` round them. The
// caller's __syncthreads() after `tile_finish` hands the tile to the block.
template <int ROWS, int COLS, int LD, int THREADS, typename T>
__device__ __forceinline__ void tile_start(float* dst, const T* src, int64_t row_stride, int r0,
                                           int Tn, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (!vec) return;
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * COLS / 4; e += THREADS) {
      const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4, t = r0 + r;
      const float* g = src + min(t, Tn - 1) * row_stride + c;  // a valid address, read or not
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + r * LD + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(g),
                   "r"(t < Tn ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

template <int ROWS, int COLS, int LD, int THREADS, typename T>
__device__ __forceinline__ void tile_finish(float* dst, const T* src, int64_t row_stride, int r0,
                                            int Tn, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      return;
    }
  }
  fill_tile<ROWS, COLS, LD, true, THREADS>(dst, src, row_stride, r0, Tn, vec);
}

// whether 16-byte loads of element type T may read rows at these strides
template <typename T>
bool rows_take_vector_loads(const void* base, int64_t sb, int64_t sh, int64_t st) {
  constexpr int64_t V = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sb % V == 0 && sh % V == 0 && st % V == 0;
}

// ------------------------------------------------------------- parameters ----

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
  float q_scale;            // on q k^T, applied to the fp32 sums (bf16 q stays exact in TF32)
  int T, H;
  // the dropout row key's heads: these H heads are [head_offset, head_offset + H)
  // of a layer of drop_heads (0: H) heads, so that a tensor-parallel shard
  // draws exactly the whole layer's mask rows for its heads
  int head_offset, drop_heads;
  int vec;                  // q, k and v take 16-byte loads (set by the launcher)
};

// -------------------------------------------- forward, dh = 64, 96 and 128 ----

constexpr int NK = 64;

// Query rows of a block, 16 a warp. At dh = 64 a block of 128 rows reads each
// K and V tile for twice the rows of a 64-row block (the kernel moves 1.3 GB
// through L2 at the tower's training shape with 64) and two blocks of 256
// threads still have 128 registers a thread; at dh = 96 and 128 the
// accumulators want more than that, so a block keeps 64 rows and 128 threads.
template <int DH>
__host__ __device__ constexpr int attention_q_rows() {
  return DH <= 64 ? 128 : 64;
}

template <int DH>
constexpr size_t attention_smem_bytes() {
  return sizeof(float) * (attention_q_rows<DH>() + 2 * NK) * (DH + 4);
}

// resident blocks: what the shared memory allows, but no more than leaves a
// thread 128 registers
template <int DH>
constexpr int attention_blocks() {
  constexpr int by_smem = blocks_per_sm<attention_smem_bytes<DH>()>();
  constexpr int by_regs = 65536 / 128 / (attention_q_rows<DH>() * 2);
  return by_smem < by_regs ? by_smem : by_regs;
}

// Warp w owns query rows 16 w + g and 16 w + g + 8 of the block's rows; for
// scores a thread holds key columns 8 j + 2t, 2t + 1 (j < 8), for the output
// head columns 8 n + 2t, 2t + 1 (n < DH / 8). A warp whose 16 rows all lie past
// T (the tail of a ragged T, most of a block at T = 50 or 77) helps to load
// the tiles and multiplies nothing. HAS_AB is a template parameter so that the kernel
// without a per-head bias carries none of its registers. The one-pass or
// three-pass product follows the output type; EXACT_S asks for the three
// passes in q k^T alone (see `launch_attention`).
template <typename TI, typename TO, int DH, bool HAS_AB, bool EXACT_S>
__global__ void __launch_bounds__(attention_q_rows<DH>() * 2, attention_blocks<DH>())
attention_kernel(const AttnParams p) {
  constexpr bool P3 = std::is_same<TO, float>::value, S3 = P3 || EXACT_S;
  constexpr int LD = DH + 4, KS = DH / 8, NQ = attention_q_rows<DH>(), N_THREADS = NQ * 2;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + NQ * LD;
  float* Vs = Ks + NK * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * NQ, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H;
  const TI* qb = static_cast<const TI*>(p.q) + b * p.sq.b + h * p.sq.h;
  const TI* kbase = static_cast<const TI*>(p.k) + b * p.sk.b + h * p.sk.h;
  const TI* vbase = static_cast<const TI*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* kb = p.key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const size_t dbh = ((size_t)b * (p.drop_heads > 0 ? p.drop_heads : H) + p.head_offset + h) * Tn;

  fill_tile<NQ, DH, LD, S3, N_THREADS>(Qs, qb, p.sq.t, q0, Tn, p.vec);

  const int r0 = warp * 16 + g;  // tile-local rows r0 and r0 + 8
  const bool live = q0 + warp * 16 < Tn;  // else all of the warp's rows lie past T
  const bool drop = p.seed != nullptr;
  uint32_t offset = 0, row_key[2] = {0, 0};
  if (drop) {
    const uint32_t sd = (uint32_t)p.seed[0];
    offset = (uint32_t)p.seed[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) row_key[i] = sc_row_key(sd, (int64_t)dbh + q0 + r0 + 8 * i);
  }
  // per-head bias rows of this thread's queries, and their gates
  const float* ab_row[2];
  float gate[2];
  if (HAS_AB) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tq = min(q0 + r0 + 8 * i, Tn - 1);  // rows past T are computed and dropped
      ab_row[i] = p.ab + h * p.ab_head_stride + (size_t)tq * Tn;
      gate[i] = p.gate != nullptr ? p.gate[bh + tq] : 1.f;
    }
  }

  float o[KS][4];
  float m_run[2] = {INIT_MAX, INIT_MAX}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  // K of a tile arrives while the block multiplies p v of the tile before,
  // V while it multiplies q k^T
  tile_start<NK, DH, LD, N_THREADS>(Ks, kbase, p.sk.t, 0, Tn, p.vec);
  for (int k0 = 0; k0 < Tn; k0 += NK) {
    tile_finish<NK, DH, LD, N_THREADS>(Ks, kbase, p.sk.t, k0, Tn, p.vec);
    __syncthreads();  // K is whole; the previous tile's V is consumed
    tile_start<NK, DH, LD, N_THREADS>(Vs, vbase, p.sv.t, k0, Tn, p.vec);

    // s = q k^T: accumulator j holds keys 8 j + 2t, 2t + 1 for rows r0, r0 + 8
    float s[NK / 8][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float a[4];
        load_a(a, Qs + r0 * LD + ks * 8 + t, LD);
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          float bb[2];
          load_bt<S3>(bb, Ks + (j * 8 + g) * LD + ks * 8 + t);
          mma_f<S3, P3>(s[j], a, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + j * 8 + 2 * t + c;
          const bool in = key < Tn;
          const float bj = in ? kb[key] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float sv = fmaf(s[j][2 * i + c], p.q_scale, bj);
            if (HAS_AB && in) sv += gate[i] * ab_row[i][key];
            s[j][2 * i + c] = in ? sv : RAGGED_KEY;
          }
        }

      // online softmax; a row's 64 scores sit in the 4 lanes of a quad
      float m_new[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = INIT_MAX;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(m_run[i], mx);
        alpha[i] = expf(m_run[i] - m_new[i]);
        m_run[i] = m_new[i];
      }
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t col_key = drop ? sc_col_key(offset, k0 + j * 8 + 2 * t + c) : 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float pe = expf(s[j][2 * i + c] - m_new[i]);
            ps[i] += pe;  // the normalizer sums every weight, kept or dropped
            float pv = pe;
            if (drop) pv = sc_keep(row_key[i], col_key, p.keep_thresh) ? pe * p.inv_keep : 0.f;
            s[j][2 * i + c] = pv;
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l_run[i] = l_run[i] * alpha[i] + ps[i];
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          o[n][2 * i] *= alpha[i];
          o[n][2 * i + 1] *= alpha[i];
        }
      }
    }

    tile_finish<NK, DH, LD, N_THREADS>(Vs, vbase, p.sv.t, k0, Tn, p.vec);
    __syncthreads();  // V is whole; K is consumed
    if (k0 + NK < Tn) tile_start<NK, DH, LD, N_THREADS>(Ks, kbase, p.sk.t, k0 + NK, Tn, p.vec);
    if (!live) continue;

    // o += p v: the score accumulators are the A operands
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      float a[4];
      acc_as_a<P3>(a, s[j]);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float bb[2];
        load_bp<P3>(bb, Vs + (j * 8 + 2 * t) * LD + n * 8 + g, LD);
        mma_f<P3, P3>(o[n], a, bb);
      }
    }
  }

  TO* ob = static_cast<TO*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = q0 + r0 + 8 * i;
    if (tq >= Tn) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const float inv = 1.f / l;
    TO* out = ob + tq * p.so.t;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      out[n * 8 + 2 * t] = from_f<TO>(o[n][2 * i] * inv);
      out[n * 8 + 2 * t + 1] = from_f<TO>(o[n][2 * i + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) p.lse[bh + tq] = m_run[i] + logf(l);
  }
}

// ---------------------------------------------- forward, dh = 768 and 1024 ----

constexpr int WK = 32, W_THREADS = 256, W_WARPS = 8;

// Query rows of a block: 32 at dh = 768, 16 at dh = 1024 (the note above)
template <int DH>
__host__ __device__ constexpr int wide_q_rows() {
  return DH > 768 ? 16 : 32;
}

template <int DH>
constexpr size_t attention_wide_smem_bytes() {
  constexpr int WQ = wide_q_rows<DH>();
  return sizeof(float) * ((WQ + WK) * (DH + 4) + W_WARPS * WQ * WK + 2 * WQ);
}
static_assert(attention_wide_smem_bytes<768>() <= 232448, "dh = 768 fits an SM");
static_assert(attention_wide_smem_bytes<1024>() <= 232448, "dh = 1024 fits an SM");

// Column of a (rows, 32) tile without padding, swizzled by the row so that the
// accumulators' 8-byte stores (half a warp: rows g < 4, columns 2t), the
// softmax's 16-byte loads and the A operand's 8-byte loads (columns 2t,
// 2t + 1 of rows g) all spread over the 32 banks. Keeps groups of 4 columns
// together.
__device__ __forceinline__ int wide_swz(int row, int col) {
  return col ^ (((row & 3) << 3) | (row & 4));
}

// Warp w owns head columns [w DH / 8, (w + 1) DH / 8) of q, k, v and of the
// output, for all WQ query rows (WQ / 16 operand tiles of 16 rows). For the
// softmax step thread tid < 8 WQ owns row tid / 8 and keys 4 (tid % 8) .. + 3
// of the tile (at WQ = 16 warps 4-7 sit that step out).
template <typename TI, typename TO, int DH, bool HAS_AB, bool EXACT_S>
__global__ void __launch_bounds__(W_THREADS, 1) attention_wide_kernel(const AttnParams p) {
  constexpr bool P3 = std::is_same<TO, float>::value, S3 = P3 || EXACT_S;
  constexpr int WQ = wide_q_rows<DH>(), MT = WQ / 16;
  constexpr int LD = DH + 4, CW = DH / W_WARPS, KS = CW / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Xs = Qs + WQ * LD;                  // one key tile: k, then v
  float* Part = Xs + WK * LD;                // 8 partial score tiles; tile 0 then holds p
  float* alpha_s = Part + W_WARPS * WQ * WK;
  float* invl_s = alpha_s + WQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * WQ, h = blockIdx.y, b = blockIdx.z;
  const int Tn = p.T, H = p.H;
  const TI* qb = static_cast<const TI*>(p.q) + b * p.sq.b + h * p.sq.h;
  const TI* kbase = static_cast<const TI*>(p.k) + b * p.sk.b + h * p.sk.h;
  const TI* vbase = static_cast<const TI*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* kb = p.key_bias + (size_t)b * Tn;
  const size_t bh = ((size_t)b * H + h) * Tn;
  const size_t dbh = ((size_t)b * (p.drop_heads > 0 ? p.drop_heads : H) + p.head_offset + h) * Tn;

  fill_tile<WQ, DH, LD, S3, W_THREADS>(Qs, qb, p.sq.t, q0, Tn, p.vec);

  // the softmax role: one row, four keys; the 8 threads of a row are
  // neighbouring lanes and keep the same running max and sum (warp-uniform)
  const bool soft = tid < 8 * WQ;
  const int srow = min(tid >> 3, WQ - 1), sc4 = (tid & 7) * 4;
  const int spos = srow * WK + wide_swz(srow, sc4);
  const int srow_t = min(q0 + srow, Tn - 1);  // rows past T are computed and dropped
  const bool drop = p.seed != nullptr;
  uint32_t offset = 0, row_key = 0;
  if (drop) {
    offset = (uint32_t)p.seed[1];
    row_key = sc_row_key((uint32_t)p.seed[0], (int64_t)dbh + q0 + srow);
  }
  const float* ab_row = HAS_AB ? p.ab + h * p.ab_head_stride + (size_t)srow_t * Tn : nullptr;
  const float gate = HAS_AB && p.gate != nullptr ? p.gate[bh + srow_t] : 1.f;
  float m_run = INIT_MAX, l_run = 0.f;

  float o[MT][KS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[m][n][c] = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += WK) {
    __syncthreads();  // the previous tile's v and p are consumed
    tile_start<WK, DH, LD, W_THREADS>(Xs, kbase, p.sk.t, k0, Tn, p.vec);
    tile_finish<WK, DH, LD, W_THREADS>(Xs, kbase, p.sk.t, k0, Tn, p.vec);
    __syncthreads();

    {  // this warp's share of s = q k^T: its own columns of q and k
      float s[MT][WK / 8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < WK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[m][j][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = warp * CW + ks * 8 + t;
        float a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) load_a(a[m], Qs + (m * 16 + g) * LD + col, LD);
#pragma unroll
        for (int j = 0; j < WK / 8; ++j) {
          float bb[2];
          load_bt<S3>(bb, Xs + (j * 8 + g) * LD + col);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_f<S3, P3>(s[m][j], a[m], bb);
        }
      }
      float* pw = Part + warp * WQ * WK;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < WK / 8; ++j) {
          const int r = m * 16 + g;
          *reinterpret_cast<float2*>(pw + r * WK + wide_swz(r, j * 8 + 2 * t)) =
              make_float2(s[m][j][0], s[m][j][1]);
          *reinterpret_cast<float2*>(pw + (r + 8) * WK + wide_swz(r + 8, j * 8 + 2 * t)) =
              make_float2(s[m][j][2], s[m][j][3]);
        }
    }
    __syncthreads();  // the partial tiles are whole; k is consumed

    tile_start<WK, DH, LD, W_THREADS>(Xs, vbase, p.sv.t, k0, Tn, p.vec);  // in flight below

    if (soft) {  // the 8 partial tiles in a fixed order, then the online softmax step
      float4 acc = *reinterpret_cast<const float4*>(Part + spos);
#pragma unroll
      for (int w = 1; w < W_WARPS; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(Part + w * WQ * WK + spos);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      float sv[4] = {acc.x, acc.y, acc.z, acc.w};
      float mx = INIT_MAX;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + sc4 + c;
        if (key < Tn) {
          sv[c] = fmaf(sv[c], p.q_scale, kb[key]);
          if (HAS_AB) sv[c] += gate * ab_row[key];
        } else {
          sv[c] = RAGGED_KEY;
        }
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pe = expf(sv[c] - m_new);
        ps += pe;  // the normalizer sums every weight, kept or dropped
        float pv = pe;
        if (drop)
          pv = sc_keep(row_key, sc_col_key(offset, k0 + sc4 + c), p.keep_thresh) ? pe * p.inv_keep
                                                                                 : 0.f;
        sv[c] = op_round<P3>(pv);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run = l_run * alpha + ps;
      m_run = m_new;
      // p takes the place of this thread's own entries of partial tile 0
      *reinterpret_cast<float4*>(Part + spos) = make_float4(sv[0], sv[1], sv[2], sv[3]);
      if ((tid & 7) == 0) alpha_s[srow] = alpha;
    }
    tile_finish<WK, DH, LD, W_THREADS>(Xs, vbase, p.sv.t, k0, Tn, p.vec);
    __syncthreads();  // p, alpha and v are whole

    // o = o alpha + p v on this warp's columns of v
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float al0 = alpha_s[m * 16 + g], al1 = alpha_s[m * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[m][n][0] *= al0;
        o[m][n][1] *= al0;
        o[m][n][2] *= al1;
        o[m][n][3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < WK / 8; ++kk) {
      float a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = m * 16 + g;
        const float2 lo = *reinterpret_cast<const float2*>(Part + r * WK +
                                                           wide_swz(r, kk * 8 + 2 * t));
        const float2 hi = *reinterpret_cast<const float2*>(Part + (r + 8) * WK +
                                                           wide_swz(r + 8, kk * 8 + 2 * t));
        a[m][0] = lo.x; a[m][1] = hi.x; a[m][2] = lo.y; a[m][3] = hi.y;
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float bb[2];
        load_bp<P3>(bb, Xs + (kk * 8 + 2 * t) * LD + warp * CW + n * 8 + g, LD);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_f<P3, P3>(o[m][n], a[m], bb);
      }
    }
  }

  if (soft && (tid & 7) == 0) {
    const float l = fmaxf(l_run, 1e-30f);
    invl_s[srow] = 1.f / l;
    if (p.lse != nullptr && q0 + srow < Tn) p.lse[bh + q0 + srow] = m_run + logf(l);
  }
  __syncthreads();
  TO* ob = static_cast<TO*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m * 16 + g + 8 * i, tq = q0 + r;
      if (tq >= Tn) continue;
      const float inv = invl_s[r];
      TO* out = ob + tq * p.so.t + warp * CW;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        out[n * 8 + 2 * t] = from_f<TO>(o[m][n][2 * i] * inv);
        out[n * 8 + 2 * t + 1] = from_f<TO>(o[m][n][2 * i + 1] * inv);
      }
    }
}

// ---------------------------------------------------------------- launches ----

template <typename TI, typename TO, int DH, bool HAS_AB, bool EXACT_S>
cudaError_t launch_attention_as(const AttnParams& p, int B, cudaStream_t stream) {
  if constexpr (DH > 128) {
    constexpr size_t smem = attention_wide_smem_bytes<DH>();
    auto kernel = attention_wide_kernel<TI, TO, DH, HAS_AB, EXACT_S>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    constexpr int rows = wide_q_rows<DH>();
    dim3 grid((p.T + rows - 1) / rows, p.H, B);
    kernel<<<grid, W_THREADS, smem, stream>>>(p);
  } else {
    constexpr size_t smem = attention_smem_bytes<DH>();
    auto kernel = attention_kernel<TI, TO, DH, HAS_AB, EXACT_S>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    constexpr int rows = attention_q_rows<DH>();
    dim3 grid((p.T + rows - 1) / rows, p.H, B);
    kernel<<<grid, rows * 2, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// The log-sum-exp is held to fp32 accuracy (1e-4 abs) whatever the output
// type: the backward recomputes the weights from it. One TF32 pass leaves
// about 1e-3 in a score, so a launch that writes lse from fp32 q and k into a
// bf16 context takes the three passes in q k^T (p v stays one pass). bf16 q
// and k are exact in TF32 and need none.
template <typename TI, typename TO, int DH, bool HAS_AB>
cudaError_t launch_attention(AttnParams p, int B, cudaStream_t stream) {
  if (B <= 0 || p.T <= 0 || p.H <= 0 || HAS_AB != (p.ab != nullptr))
    return cudaErrorInvalidValue;
  if (p.head_offset < 0 || (p.drop_heads > 0 && p.head_offset + p.H > p.drop_heads) ||
      (p.drop_heads == 0 && p.head_offset != 0))
    return cudaErrorInvalidValue;
  if (p.sq.t < 0 || p.sk.t < 0 || p.sv.t < 0 || p.so.t < 0) return cudaErrorInvalidValue;
  p.vec = rows_take_vector_loads<TI>(p.q, p.sq.b, p.sq.h, p.sq.t) &&
          rows_take_vector_loads<TI>(p.k, p.sk.b, p.sk.h, p.sk.t) &&
          rows_take_vector_loads<TI>(p.v, p.sv.b, p.sv.h, p.sv.t);
  if constexpr (std::is_same<TI, float>::value && !std::is_same<TO, float>::value) {
    if (p.lse != nullptr) return launch_attention_as<TI, TO, DH, HAS_AB, true>(p, B, stream);
  }
  return launch_attention_as<TI, TO, DH, HAS_AB, false>(p, B, stream);
}

// q, k, v, o as (B, H, T, dh) tensors given by their element strides
// (strides[0..2] of q, then k, v, o), in one dtype. A template so that only
// the sources that call it instantiate its kernels.
template <typename = void>
cudaError_t launch_bhtd_attention(
    const void* q, const void* k, const void* v, void* o, const int64_t* strides,
    const float* key_bias, int B, int H, int T, int dh, int is_bf16, float q_scale,
    const int64_t* seed, uint32_t keep_thresh, float inv_keep, float* lse,
    cudaStream_t stream, int head_offset = 0, int drop_heads = 0) {
  AttnParams p = {};
  p.head_offset = head_offset;
  p.drop_heads = drop_heads;
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
