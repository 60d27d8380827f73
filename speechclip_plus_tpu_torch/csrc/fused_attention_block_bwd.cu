// Fused attention block, backward (K2): the entry point. The kernels and the
// note on them are in attention_bwd.cuh; they are instantiated per head dim in
// fused_attention_block_bwd_dh{64,96,128,768,1024}.cu, so that the head dims compile
// side by side.
#include "attention_bwd.cuh"

extern "C" {

int sc_fab_attention_bwd_dh64(SC_FAB_BWD_PARAMS, int g_bf16);
int sc_fab_attention_bwd_dh96(SC_FAB_BWD_PARAMS, int g_bf16);
int sc_fab_attention_bwd_dh128(SC_FAB_BWD_PARAMS, int g_bf16);
int sc_fab_attention_bwd_dh768(SC_FAB_BWD_PARAMS, int g_bf16);
int sc_fab_attention_bwd_dh1024(SC_FAB_BWD_PARAMS, int g_bf16);

// dqkv (B, T, 3*H*dh) from the packed fp32 qkv (q scaled by `scale`), the
// key bias (B, T) fp32, the optional per-head bias `ab` (ab_heads, T, T) fp32
// with ab_heads 1 or H (null for none), the context cotangent dctx and the
// context ctx (B, T, H*dh; bf16 when g_bf16, else fp32, as is dqkv), K1's log-sum-exp
// lse (B, H, T) fp32, and the dropout seed (device int64 [seed, offset], or
// null for none) with its threshold and 1/keep. Scratch: dvec (B, H, T)
// fp32. dq is returned times `scale`. dh is 64, 96, 128, 768 or 1024. Returns a
// cudaError_t.
int sc_fab_attention_bwd(const float* qkv, const float* key_bias, const float* ab,
                         int ab_heads, const void* dctx,
                         const void* ctx, const float* lse, float* dvec,
                         const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                         float scale, void* dqkv, int B, int Tn, int H, int dh,
                         int g_bf16, cudaStream_t stream) {
  switch (dh) {
    case 64: return sc_fab_attention_bwd_dh64(SC_FAB_BWD_ARGS, g_bf16);
    case 96: return sc_fab_attention_bwd_dh96(SC_FAB_BWD_ARGS, g_bf16);
    case 128: return sc_fab_attention_bwd_dh128(SC_FAB_BWD_ARGS, g_bf16);
    case 768: return sc_fab_attention_bwd_dh768(SC_FAB_BWD_ARGS, g_bf16);
    case 1024: return sc_fab_attention_bwd_dh1024(SC_FAB_BWD_ARGS, g_bf16);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
