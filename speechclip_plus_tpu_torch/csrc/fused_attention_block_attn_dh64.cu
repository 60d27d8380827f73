// Fused attention block (K1): the attention kernels at head dim 64, for a bf16
// and an fp32 context, reached through sc_fab_attention. The towers (16 or 12 heads
// of 64), the ViTs and the text towers.
#include "fused_attention_block_attn.cuh"

extern "C" int sc_fab_attention_dh64(SC_FAB_ATTN_PARAMS, int ctx_bf16) {
  return block_attention_at<64>(SC_FAB_ATTN_ARGS, ctx_bf16);
}
