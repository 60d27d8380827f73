// Counter-based dropout mask shared by the attention forward (K1) and
// backward (K2): element (b, h, i, j) of a (B, H, T, T) attention-weight
// tensor is kept iff
//
//   mix32(mix32(row ^ seed) ^ mix32(j + offset)) < thresh,
//   row = (b * H + h) * T + i,   thresh = round(keep_prob * 2^32),
//
// with H the heads of the whole layer and h a head's index among them: a
// tensor-parallel shard of heads [h0, h0 + H_r) keys its rows by h0 + its own
// head index and the layer's H (AttnParams::head_offset, drop_heads), so it
// draws exactly the whole layer's mask rows for those heads.
//
// with mix32 the "lowbias32" integer finalizer (a bijection on 32 bits).
// The mask is a pure function of (seed, offset, b, h, i, j), so it does not
// depend on tiling: the backward regenerates the forward's mask without a
// saved mask. `ops/random.py` computes the same bits in int64 torch ops.
// Replaces the TPU's `pltpu.prng_seed` / `prng_random_bits` streams.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t sc_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// per-row and per-column halves of the hash; keep iff mix32(rk ^ ck) < thresh
__device__ __forceinline__ uint32_t sc_row_key(uint32_t seed, int64_t row) {
  return sc_mix32((uint32_t)row ^ seed);
}
__device__ __forceinline__ uint32_t sc_col_key(uint32_t offset, int col) {
  return sc_mix32((uint32_t)col + offset);
}
__device__ __forceinline__ bool sc_keep(uint32_t row_key, uint32_t col_key,
                                        uint32_t thresh) {
  return sc_mix32(row_key ^ col_key) < thresh;
}
