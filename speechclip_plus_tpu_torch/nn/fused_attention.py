"""Attention with in-kernel dropout on (B, H, T, dh), forward only (K5).

Port of ``speechclip_plus_tpu/nn/fused_attention.py`` (Pallas `_kernel`,
:67), the frozen acoustic tower's opt-in attention
(`audio_encoder.fused_attention`):

    out = dropout(softmax(q kᵀ / sqrt(dh) + key_bias)) v

On a CUDA tensor it runs the hand-written kernel in
``csrc/fused_attention.cu`` (an online softmax over key tiles; the (T, T)
weights and the dropout mask never leave the SM). On a CPU tensor it runs
`plain_fused_attention_dropout`, the same function in plain PyTorch. There is
no fallback from one to the other: the JAX wrapper's routes to XLA (off the
TPU, beyond its on-chip memory) have no counterpart here.

q, k and v are read through their strides (the head dim must be contiguous),
so the (B, H, T, dh) views of a packed (B, T, 3D) projection cost no
transpose copy; the output is a (B, H, T, dh) view of a (B, T, H·dh) buffer,
so merging the heads afterwards is a view too. Dropout uses the counter mask
of ``ops/random.py`` with row = (b·H + h)·T + i: with the same (seed, offset)
it is the mask K1's context-only mode draws; on a tensor-parallel range of
heads (`head_offset`, `total_heads`) h and H are the layer's, so a shard
draws the whole layer's mask rows for its heads. Forward only: the tower is
frozen, and a backward raises, as ``_fused_bwd`` does on the JAX side.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.random import attention_keep_mask, draw_seed, keep_threshold

__all__ = ["fused_attention_dropout", "plain_fused_attention_dropout", "bhtd_strides",
           "check_bhtd", "LAUNCHES", "SHARD_LAUNCHES"]

# wrapper calls that launched the kernel on the card
LAUNCHES = 0
# those of them on a tensor-parallel range of heads
SHARD_LAUNCHES = 0

_HEAD_DIMS = (64, 96)


def plain_fused_attention_dropout(q, k, v, key_padding_bias=None, seeds=None,
                                  keep_prob: float = 1.0, head_offset: int = 0,
                                  total_heads=None):
    """Plain PyTorch twin of the kernel: fp32 arithmetic on the operands'
    values, the output rounded to q's dtype. `seeds` (the (2,) int64 [seed,
    offset]) turns on dropout at `keep_prob` with the int64 counter mask, on
    heads [head_offset, head_offset + H) of `total_heads`."""
    b, h, t, dh = q.shape
    s = torch.matmul(q.float() * dh ** -0.5, k.float().transpose(-1, -2))
    if key_padding_bias is not None:
        s = s + key_padding_bias.float()[:, None, None, :]
    w = torch.softmax(s, dim=-1)
    if seeds is not None:
        w = torch.where(attention_keep_mask(seeds, b, h, t, keep_prob, head_offset, total_heads),
                        w / keep_prob, 0.0)
    return torch.matmul(w, v.float()).to(q.dtype)


def bhtd_strides(*tensors):
    """The (b, h, t) element strides of (B, H, T, dh) tensors as the host int64
    array the kernels take."""
    flat = [s for a in tensors for s in a.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def check_bhtd(name: str, q, k, v, key_padding_bias):
    """What the (B, H, T, dh) kernels take: one CUDA device, one dtype (fp32 or
    bf16), one shape, a contiguous head dim of 64 or 96. Returns the fp32
    contiguous (B, T) key bias."""
    b, h, t, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} (fp32 or bf16)")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {_HEAD_DIMS}")
    for label, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name}: {label} {tuple(a.shape)} {a.dtype} {a.device}; want "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
        if a.stride(-1) != 1:
            raise ValueError(f"{name}: {label} needs a contiguous head dim "
                             f"(strides {a.stride()})")
    if key_padding_bias is None:
        return torch.zeros(b, t, dtype=torch.float32, device=q.device)
    if tuple(key_padding_bias.shape) != (b, t) or key_padding_bias.device != q.device:
        raise ValueError(f"{name}: key_padding_bias {tuple(key_padding_bias.shape)}; "
                         f"want {(b, t)} on {q.device}")
    return key_padding_bias.to(torch.float32).contiguous()


def _launch(q, k, v, key_padding_bias, seeds, keep_prob, head_offset=0, total_heads=None):
    global LAUNCHES, SHARD_LAUNCHES
    from ..utils.cuda_build import check, kernels

    b, h, t, dh = q.shape
    total = total_heads or h
    kb = check_bhtd("fused_attention_dropout", q, k, v, key_padding_bias)
    if not 0 <= head_offset <= total - h:
        raise ValueError(f"fused_attention_dropout: heads [{head_offset}, {head_offset + h}) "
                         f"of {total}")
    if seeds is not None and (seeds.device != q.device or seeds.dtype != torch.int64
                              or tuple(seeds.shape) != (2,)):
        raise ValueError("fused_attention_dropout: seeds must be (2,) int64 on q's device")
    lib = kernels()
    with torch.cuda.device(q.device):
        out = torch.empty(b, t, h, dh, dtype=q.dtype, device=q.device).transpose(1, 2)
        check(lib.sc_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bhtd_strides(q, k, v, out), kb.data_ptr(), b, h, t, dh,
            int(q.dtype == torch.bfloat16), dh ** -0.5,
            None if seeds is None else seeds.data_ptr(), keep_threshold(keep_prob),
            1.0 / keep_prob, head_offset, total, torch.cuda.current_stream().cuda_stream),
            "fused_attention_dropout")
    LAUNCHES += 1
    SHARD_LAUNCHES += total != h
    return out


def _run(q, k, v, key_padding_bias=None, seeds=None, keep_prob: float = 1.0,
         head_offset: int = 0, total_heads=None):
    """The kernel on CUDA tensors, the twin on CPU tensors; dropout from the
    (2,) int64 [seed, offset] pair `seeds` (None: none). No autograd."""
    if q.device.type == "cpu":
        return plain_fused_attention_dropout(q, k, v, key_padding_bias, seeds, keep_prob,
                                             head_offset, total_heads)
    if q.device.type != "cuda":
        raise NotImplementedError(f"fused_attention_dropout on {q.device.type}")
    return _launch(q, k, v, key_padding_bias, seeds, keep_prob, head_offset, total_heads)


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_padding_bias, seeds, keep_prob, head_offset, total_heads):
        return _run(q, k, v, key_padding_bias, seeds, keep_prob, head_offset, total_heads)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "fused_attention_dropout is forward-only (frozen-tower path); use "
            "nn.attention.dot_product_attention for trainable towers")


def fused_attention_dropout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_padding_bias: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    head_offset: int = 0,
    total_heads: Optional[int] = None,
) -> torch.Tensor:
    """q, k, v (B, H, T, dh); key_padding_bias (B, T) additive fp32 (-1e30 at
    pads). Returns (B, H, T, dh) in q's dtype. Dropout on the attention
    weights at `dropout_rate` when a `generator` is given (one (seed, offset)
    pair is drawn from it). The H heads are heads [head_offset, head_offset
    + H) of a layer of `total_heads` (default H) in the mask's row key."""
    seeds, keep_prob = None, 1.0
    if dropout_rate > 0.0 and generator is not None:
        seeds, keep_prob = draw_seed(generator), 1.0 - float(dropout_rate)
    return _ForwardOnly.apply(q, k, v, key_padding_bias, seeds, keep_prob, head_offset,
                              total_heads)
