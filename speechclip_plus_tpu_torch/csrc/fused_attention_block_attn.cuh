// Fused attention block (K1): the attention kernel on the packed qkv buffer,
// for a context of type TO, from the entry point's arguments
// (fused_attention_block_attn.cu says what they are).
#pragma once
#include "attention_core.cuh"

namespace {

template <typename TO>
cudaError_t block_attention(const float* qkv, const float* key_bias, void* ctx, int B, int Tn,
                            int H, int dh, const float* ab, int ab_heads, const float* gate,
                            const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                            float* lse, cudaStream_t stream) {
  if (gate != nullptr && ab == nullptr) return cudaErrorInvalidValue;
  if (ab != nullptr && ab_heads != 1 && ab_heads != H) return cudaErrorInvalidValue;
  const int64_t D = (int64_t)H * dh;
  AttnParams p = {};
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.o = ctx;
  p.sq = p.sk = p.sv = {(int64_t)Tn * 3 * D, dh, 3 * D};
  p.so = {(int64_t)Tn * D, dh, D};
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
#define SC_ATTN(DHV)                                                      \
  (ab != nullptr ? launch_attention<float, TO, DHV, true>(p, B, stream)   \
                 : launch_attention<float, TO, DHV, false>(p, B, stream))
  if (dh == 64) return SC_ATTN(64);
  if (dh == 96) return SC_ATTN(96);
  if (dh == 768) return SC_ATTN(768);
#undef SC_ATTN
  return cudaErrorInvalidValue;
}

}  // namespace
