// Fused attention block, backward (K2): the kernels at head dim 1024, for bf16
// and fp32 cotangents, reached through sc_fab_attention_bwd. The fixed-K large
// branches (cascaded and hybrid large: one head over 1024). Replaces the Pallas
// `_bwd_kernel` of speechclip_plus_tpu/nn/fused_attention_block_vjp.py:104 at
// this head, which the TPU runs through XLA (no head grouping fits its VMEM
// budget). The kernels are `attention_bwd_wide_kernel` of attention_bwd.cuh
// with 16 own rows and the other rows 8 at a time (207 KB of shared memory;
// the note there says why).
#include "attention_bwd.cuh"

extern "C" int sc_fab_attention_bwd_dh1024(SC_FAB_BWD_PARAMS, int g_bf16) {
  return attention_bwd_at<1024>(SC_FAB_BWD_ARGS, g_bf16);
}
