// Fused attention block, backward (K2): the kernels at head dim 128, for bf16
// and fp32 cotangents, reached through sc_fab_attention_bwd. The large branches (8
// heads over 1024).
#include "attention_bwd.cuh"

extern "C" int sc_fab_attention_bwd_dh128(SC_FAB_BWD_PARAMS, int g_bf16) {
  return attention_bwd_at<128>(SC_FAB_BWD_ARGS, g_bf16);
}
