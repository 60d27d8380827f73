// Fused attention block, backward (K2): the entry point, and the kernels for
// bf16 cotangents. The kernels and the note on them are in attention_bwd.cuh;
// those for fp32 cotangents are instantiated in
// fused_attention_block_bwd_f32.cu, so that the two halves compile side by
// side.
#include "attention_bwd.cuh"

extern "C" {

int sc_fab_attention_bwd_f32(const float* qkv, const float* key_bias, const float* ab,
                             int ab_heads, const void* dctx, const void* ctx, const float* lse,
                             float* dvec, const int64_t* seed, unsigned int keep_thresh,
                             float inv_keep, float scale, void* dqkv, int B, int Tn, int H,
                             int dh, cudaStream_t stream);

// dqkv (B, T, 3*H*dh) from the packed fp32 qkv (q scaled by `scale`), the
// key bias (B, T) fp32, the optional per-head bias `ab` (ab_heads, T, T) fp32
// with ab_heads 1 or H (null for none), the context cotangent dctx and the
// context ctx (B, T, H*dh; bf16 when g_bf16, else fp32, as is dqkv), K1's log-sum-exp
// lse (B, H, T) fp32, and the dropout seed (device int64 [seed, offset], or
// null for none) with its threshold and 1/keep. Scratch: dvec (B, H, T)
// fp32. dq is returned times `scale`. Returns a cudaError_t.
int sc_fab_attention_bwd(const float* qkv, const float* key_bias, const float* ab,
                         int ab_heads, const void* dctx,
                         const void* ctx, const float* lse, float* dvec,
                         const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                         float scale, void* dqkv, int B, int Tn, int H, int dh,
                         int g_bf16, cudaStream_t stream) {
  if (!g_bf16)
    return sc_fab_attention_bwd_f32(qkv, key_bias, ab, ab_heads, dctx, ctx, lse, dvec, seed,
                                    keep_thresh, inv_keep, scale, dqkv, B, Tn, H, dh, stream);
  return (int)attention_bwd<bf16>(qkv, key_bias, ab, ab_heads, dctx, ctx, lse, dvec, seed,
                                  keep_thresh, inv_keep, scale, dqkv, B, Tn, H, dh, stream);
}

}  // extern "C"
