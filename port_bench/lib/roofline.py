"""Peaks of the card and the operations and bytes of each kernel call.

A roofline share is the least time the card could take over the time it
took. The least time of a call is the larger of its operations over the
dense bf16 peak and its bytes over the memory bandwidth: every share counts
against the bf16 peak, the configurations' precision, whatever precision a
kernel uses inside. Bytes: each input read once, each output written once.
Operations: 2 a multiply-add, matrix products only (softmax, exponentials
and masks are not counted).
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAKS", "peak", "least_s", "projection", "k1_fused_out", "k1_context", "k2",
           "k3", "k3b"]

# published dense rates of the SXM part (NVIDIA's data sheet): bf16 FLOP/s,
# HBM bytes/s
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "hbm": 3.35e12},
}


def peak(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def least_s(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    return max(flops / pk["bf16"], nbytes / pk["hbm"])


def projection(m: int, n: int, k: int, out_bytes: int = 4):
    """K1a: (m, k) bf16 x (n, k) bf16 + fp32 bias -> (m, n)."""
    return 2.0 * m * n * k, 2.0 * (m * k + n * k) + 4.0 * n + out_bytes * m * n


def _attn(b, t, d, h):
    return 4.0 * b * h * t * t * (d // h)


def k1_fused_out(b: int, t: int, d: int, h: int):
    """K1 with the out-projection fused in: qkv, attention, out-projection."""
    m = b * t
    flops = 2.0 * m * d * 3 * d + _attn(b, t, d, h) + 2.0 * m * d * d
    nbytes = (2.0 * m * d + 2.0 * 3 * d * d + 4.0 * 3 * d + 2.0 * d * d + 2.0 * d
              + 4.0 * b * t + 2.0 * m * d)
    return flops, nbytes


def k1_context(b: int, t: int, d: int, h: int):
    """K1 context-only (the branch's forward): qkv and attention; writes the
    context, the fp32 qkv and the per-row log-sum-exp its backward reads."""
    m = b * t
    flops = 2.0 * m * d * 3 * d + _attn(b, t, d, h)
    nbytes = (2.0 * m * d + 2.0 * 3 * d * d + 4.0 * 3 * d + 4.0 * b * t
              + 2.0 * m * d + 4.0 * m * 3 * d + 4.0 * b * h * t)
    return flops, nbytes


def k2(b: int, t: int, d: int, h: int):
    """K2, the attention backward: scores again, dP, dV, dQ, dK; reads the
    fp32 qkv, the key bias, the context and its cotangent and the lse,
    writes dqkv in bf16."""
    m = b * t
    flops = 2.5 * _attn(b, t, d, h)
    nbytes = 4.0 * m * 3 * d + 4.0 * b * t + 2.0 * 2 * m * d + 4.0 * b * h * t + 2.0 * m * 3 * d
    return flops, nbytes


def k3(n: int, d: int, v: int):
    """K3: cosine scores of n keywords against v codes, the argmax, the
    entropy and the column sums of the softmax."""
    return 2.0 * n * d * v, 2.0 * (n * d + v * d) + 4.0 * v + 4.0 * (2 * n + v)


def k3b(n: int, d: int, v: int):
    """K3b: scores, the cotangent's products with the codes, dx."""
    return 6.0 * n * d * v, 2.0 * (2 * n * d + v * d) + 4.0 * 2 * v + 4.0 * n * d + 4.0
