// Fused attention block, backward (K2): the kernels at head dim 64, for bf16
// and fp32 cotangents, reached through sc_fab_attention_bwd. The text tower's
// fused route (8 heads of 64).
#include "attention_bwd.cuh"

extern "C" int sc_fab_attention_bwd_dh64(SC_FAB_BWD_PARAMS, int g_bf16) {
  return attention_bwd_at<64>(SC_FAB_BWD_ARGS, g_bf16);
}
