// Attention with in-kernel dropout on (B, H, T, dh), forward only (K5), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of
// speechclip_plus_tpu/nn/fused_attention.py:67 (launched by `_pallas_fwd`,
// :110): out = dropout(softmax(q k^T / sqrt(dh) + key_bias)) v for the frozen
// acoustic tower, whose q, k, v and out-projection are plain linear layers.
//
// What bounds it on the H100. The function moves q, k, v and o once (252 MB
// in bf16 at B=128, H=12, T=320, dh=64): it is bound by bytes, as long as the
// (T, T) weights and the dropout mask stay on the SM. The TPU kernel held one
// batch element's heads and a whole (T, T) fp32 score tile in VMEM and padded
// T to 128; a (320, 320) fp32 tile is 410 KB against 227 KB of shared memory,
// so this kernel is the online softmax over 64-key tiles of
// attention_core.cuh, with the ragged edge masked in the kernel. q, k and v
// are read through their strides, so the (B, H, T, dh) views of a packed
// (B, T, 3D) projection are read in place (the TPU version paid for
// materialized transposes), and the output may be a (B, H, T, dh) view of a
// (B, T, D) buffer. The dropout mask is the counter mask of dropout_mask.cuh
// with row = (b * H + h) * T + i: with the same (seed, offset) it is the mask
// K1's context-only mode draws.
//
// Both products run on the tensor cores (TF32 mma, attention_core.cuh); no
// pipelining.
#include "attention_core.cuh"

extern "C" {

// q, k, v, o: (B, H, T, dh) in one dtype (fp32, or bf16 when is_bf16), given
// by 12 element strides (b, h, t of q, k, v, o; dh contiguous). key_bias
// (B, T) fp32. `seed` is the device int64 [seed, offset] pair (null: no
// dropout). The H heads are heads [head_offset, head_offset + H) of a layer
// of drop_heads (0: H) heads in the mask's row key (a tensor-parallel
// shard). Returns a cudaError_t.
int sc_fused_attention(const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, const float* key_bias,
                       int B, int H, int T, int dh, int is_bf16, float q_scale,
                       const int64_t* seed, unsigned int keep_thresh, float inv_keep,
                       int head_offset, int drop_heads, cudaStream_t stream) {
  return (int)launch_bhtd_attention<>(q, k, v, o, strides, key_bias, B, H, T, dh, is_bf16,
                                    q_scale, seed, keep_thresh, inv_keep, nullptr, stream,
                                    head_offset, drop_heads);
}

}  // extern "C"
