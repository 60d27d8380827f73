// Fused attention block (K1): the attention kernels for an fp32 context (the
// tests' and the parity checks' mode), reached through sc_fab_attention.
#include "fused_attention_block_attn.cuh"

extern "C" {

int sc_fab_attention_f32(const float* qkv, const float* key_bias, void* ctx, int B, int Tn, int H,
                         int dh, const float* ab, int ab_heads, const float* gate,
                         const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                         float* lse, cudaStream_t stream) {
  return (int)block_attention<float>(qkv, key_bias, ctx, B, Tn, H, dh, ab, ab_heads, gate, seed,
                                     keep_thresh, inv_keep, lse, stream);
}

}  // extern "C"
