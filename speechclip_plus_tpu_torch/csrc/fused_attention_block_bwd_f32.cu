// Fused attention block, backward (K2): the kernels for fp32 cotangents (the
// tests' and the parity checks' mode), reached through sc_fab_attention_bwd.
#include "attention_bwd.cuh"

extern "C" {

int sc_fab_attention_bwd_f32(const float* qkv, const float* key_bias, const float* ab,
                             int ab_heads, const void* dctx, const void* ctx, const float* lse,
                             float* dvec, const int64_t* seed, unsigned int keep_thresh,
                             float inv_keep, float scale, void* dqkv, int B, int Tn, int H,
                             int dh, cudaStream_t stream) {
  return (int)attention_bwd<float>(qkv, key_bias, ab, ab_heads, dctx, ctx, lse, dvec, seed,
                                   keep_thresh, inv_keep, scale, dqkv, B, Tn, H, dh, stream);
}

}  // extern "C"
