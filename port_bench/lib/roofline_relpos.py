"""Operations and bytes of K1's attention kernel in WavLM's gated mode.

A call of the tower's K1 with the gated relative position bias runs the
attention kernel (K1b) on the block's fp32 (B, T, 3D) qkv buffer, q scaled,
with the key padding bias (B, T), the shared fp32 (H, T, T) bias and the fp32
(B, H, T) gate; it writes the bf16 context (B, T, D) the out-projection
reads. Operations: 2 a multiply-add of q kᵀ and of the weights times v (the
gate's multiply-add into each score, the softmax and the dropout mask are
not counted, as `roofline.py` counts none of them). Bytes: each input read
once, the bias once a call, the output written once. The projections around
it are K1a, the same kernel as every other projection of the step, and are
not part of this count.
"""
from __future__ import annotations

__all__ = ["k1_gated_attention"]


def k1_gated_attention(b: int, t: int, d: int, h: int):
    """(flops, bytes) of one gated attention call at batch b, T frames,
    width d and h heads."""
    flops = 4.0 * b * h * t * t * (d // h)
    nbytes = 4.0 * b * t * 3 * d + 4.0 * b * t + 4.0 * h * t * t + 4.0 * b * h * t \
        + 2.0 * b * t * d
    return flops, nbytes
