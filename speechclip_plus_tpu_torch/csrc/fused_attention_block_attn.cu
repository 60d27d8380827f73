// Fused attention block (K1): the attention kernel's entry point. The kernels
// are the forward templates of attention_core.cuh, instantiated per head dim
// in fused_attention_block_attn_dh{64,96,128,768,1024}.cu; the projection GEMMs and
// the note on the whole block are in fused_attention_block.cu.
#include "fused_attention_block_attn.cuh"

extern "C" {

int sc_fab_attention_dh64(SC_FAB_ATTN_PARAMS, int ctx_bf16);
int sc_fab_attention_dh96(SC_FAB_ATTN_PARAMS, int ctx_bf16);
int sc_fab_attention_dh128(SC_FAB_ATTN_PARAMS, int ctx_bf16);
int sc_fab_attention_dh768(SC_FAB_ATTN_PARAMS, int ctx_bf16);
int sc_fab_attention_dh1024(SC_FAB_ATTN_PARAMS, int ctx_bf16);

// ctx (B, T, H*dh), fp32 or bf16 (ctx_bf16), = per-head
// softmax(q k^T + key_bias [+ gate * ab]) v over the packed fp32 qkv
// (B, T, 3*H*dh) buffer (q already scaled). key_bias (B, T) fp32. `ab` is the
// fp32 per-head bias (ab_heads, T, T) with ab_heads 1 or H, or null; `gate`
// the fp32 (B, H, T) factor on it, or null (only with `ab`). With `seed`
// (device int64 [seed, offset]; null for none) the weights go through the
// dropout mask of dropout_mask.cuh with `keep_thresh`, kept ones scaled by
// `inv_keep`. `lse` (B, H, T) fp32 receives the per-row log-sum-exp when
// not null. dh is 64, 96, 128, 768 or 1024. The H heads are heads
// [head_offset, head_offset + H) of a layer of drop_heads (0: H) heads, in
// the dropout mask's row key alone (a tensor-parallel shard's heads; `ab`
// and `gate` are the shard's own).
int sc_fab_attention(const float* qkv, const float* key_bias, void* ctx,
                     int B, int Tn, int H, int dh, int ctx_bf16,
                     const float* ab, int ab_heads, const float* gate,
                     const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                     float* lse, int head_offset, int drop_heads, cudaStream_t stream) {
  switch (dh) {
    case 64: return sc_fab_attention_dh64(SC_FAB_ATTN_ARGS, ctx_bf16);
    case 96: return sc_fab_attention_dh96(SC_FAB_ATTN_ARGS, ctx_bf16);
    case 128: return sc_fab_attention_dh128(SC_FAB_ATTN_ARGS, ctx_bf16);
    case 768: return sc_fab_attention_dh768(SC_FAB_ATTN_ARGS, ctx_bf16);
    case 1024: return sc_fab_attention_dh1024(SC_FAB_ATTN_ARGS, ctx_bf16);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
