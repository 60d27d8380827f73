// Flash attention forward with the log-sum-exp output (K4), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// speechclip_plus_tpu/nn/flash.py:47 (launched by `_pallas_fwd`, :103):
// out = softmax(q k^T / sqrt(dh) + key_bias) v on (B, H, T, dh) and
// lse = m + log(max(l, 1e-30)) (B, H, T) fp32, which the backward (plain
// tensor code, as in the JAX package) recomputes the weights from.
//
// What bounds it on the H100. At the long-audio shape (B=8, H=12, T=1499,
// dh=64) the two products are 55 GFLOP against 74 MB of q, k, v and o in bf16:
// it is bound by operations. The TPU kernel padded T to its block size and
// walked a sequential grid with the running max and sum in VMEM scratch;
// here one block owns 64 query rows and loops over 64-key tiles itself
// (attention_core.cuh), and T = 1499, a multiple of no tile, is masked in the
// kernel. q, k, v and o are read through their strides, with no copy.
//
// Both products run on the tensor cores (TF32 mma; bf16 inputs are exact in
// TF32, fp32 inputs take the three-pass split); nothing is pipelined.
#include "attention_core.cuh"

extern "C" {

// q, k, v, o: (B, H, T, dh) in one dtype (fp32, or bf16 when is_bf16), given
// by 12 element strides (b, h, t of q, k, v, o; dh contiguous). key_bias
// (B, T) fp32; lse (B, H, T) fp32 contiguous. Returns a cudaError_t.
int sc_flash_attention(const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, const float* key_bias, float* lse,
                       int B, int H, int T, int dh, int is_bf16, float q_scale,
                       cudaStream_t stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_bhtd_attention<>(q, k, v, o, strides, key_bias, B, H, T, dh, is_bf16,
                                    q_scale, nullptr, 0u, 1.f, lse, stream);
}

}  // extern "C"
