// Fused attention block (K1): the attention kernels at head dim 128, for a bf16
// and an fp32 context, reached through sc_fab_attention. The large branches (8 heads
// over 1024).
#include "fused_attention_block_attn.cuh"

extern "C" int sc_fab_attention_dh128(SC_FAB_ATTN_PARAMS, int ctx_bf16) {
  return block_attention_at<128>(SC_FAB_ATTN_ARGS, ctx_bf16);
}
