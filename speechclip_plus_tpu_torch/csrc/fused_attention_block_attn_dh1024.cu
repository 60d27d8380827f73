// Fused attention block (K1): the attention kernels at head dim 1024, for a bf16
// and an fp32 context, reached through sc_fab_attention. The fixed-K large
// branches (cascaded and hybrid large: one head over 1024). Replaces the Pallas
// `_kernel` of speechclip_plus_tpu/nn/fused_attention_block.py:118 at this
// head, which the TPU runs through XLA (no head grouping fits its VMEM budget).
// The kernel is `attention_wide_kernel` of attention_core.cuh with 16 query
// rows a block (214 KB of shared memory; the note there says why); bounded by
// its products at the branch's training shape.
#include "fused_attention_block_attn.cuh"

extern "C" int sc_fab_attention_dh1024(SC_FAB_ATTN_PARAMS, int ctx_bf16) {
  return block_attention_at<1024>(SC_FAB_ATTN_ARGS, ctx_bf16);
}
