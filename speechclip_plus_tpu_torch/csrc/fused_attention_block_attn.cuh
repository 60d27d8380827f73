// Fused attention block (K1): the attention kernel on the packed qkv buffer,
// for a context of type TO and one head dim, from the entry point's arguments
// (fused_attention_block_attn.cu says what they are). Each head dim's kernels
// are instantiated in a source of their own, fused_attention_block_attn_dh*.cu,
// so that they compile side by side.
#pragma once
#include "attention_core.cuh"

// the entry point's arguments after `ctx`, with and without their types
#define SC_FAB_ATTN_PARAMS                                                              \
  const float *qkv, const float *key_bias, void *ctx, int B, int Tn, int H,             \
      const float *ab, int ab_heads, const float *gate, const int64_t *seed,            \
      unsigned int keep_thresh, float inv_keep, float *lse, int head_offset, int drop_heads, \
      cudaStream_t stream
#define SC_FAB_ATTN_ARGS                                                                \
  qkv, key_bias, ctx, B, Tn, H, ab, ab_heads, gate, seed, keep_thresh, inv_keep, lse, \
      head_offset, drop_heads, stream

namespace {

template <typename TO, int DH>
cudaError_t block_attention(SC_FAB_ATTN_PARAMS) {
  if (gate != nullptr && ab == nullptr) return cudaErrorInvalidValue;
  if (ab != nullptr && ab_heads != 1 && ab_heads != H) return cudaErrorInvalidValue;
  const int64_t D = (int64_t)H * DH;
  AttnParams p = {};
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.o = ctx;
  p.sq = p.sk = p.sv = {(int64_t)Tn * 3 * D, DH, 3 * D};
  p.so = {(int64_t)Tn * D, DH, D};
  p.key_bias = key_bias;
  p.ab = ab;
  p.ab_head_stride = ab_heads == 1 ? 0 : (int64_t)Tn * Tn;
  p.gate = gate;
  p.seed = seed;
  p.keep_thresh = keep_thresh;
  p.inv_keep = inv_keep;
  p.lse = lse;
  p.q_scale = 1.f;
  p.T = Tn;
  p.H = H;
  p.head_offset = head_offset;
  p.drop_heads = drop_heads;
  return ab != nullptr ? launch_attention<float, TO, DH, true>(p, B, stream)
                       : launch_attention<float, TO, DH, false>(p, B, stream);
}

// a bf16 or an fp32 context at head dim DH
template <int DH>
int block_attention_at(SC_FAB_ATTN_PARAMS, int ctx_bf16) {
  return (int)(ctx_bf16 ? block_attention<bf16, DH>(SC_FAB_ATTN_ARGS)
                        : block_attention<float, DH>(SC_FAB_ATTN_ARGS));
}

}  // namespace
