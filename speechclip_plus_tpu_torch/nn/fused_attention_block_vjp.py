"""Differentiable fused attention block (the branch self-attention).

Port of ``speechclip_plus_tpu/nn/fused_attention_block_vjp.py``. The
autograd boundary is the same as the JAX `custom_vjp` (`_attn_core`, :354):

    forward   x (B, T, D) -> ctx (B, T, D): K1 context-only, with dropout
    backward  dctx -> dqkv (B, T, 3D): K2 (Pallas `_bwd_kernel`, :104)
    outside   dx = dqkv Wqkv, dWqkv = dqkvᵀ x, dbqkv = Σ dqkv (torch.matmul
              and sums, as XLA outside the kernel in JAX, :382-390), and the
              out-projection ctx Woᵀ + bo with its own autograd

The forward saves K1's fp32 qkv buffer, its per-row log-sum-exp and the
(seed, offset) pair of the dropout mask; K2 recomputes p from them and
regenerates the mask (``ops/random.py``), so no (B, H, T, T) tensor is saved.
On a CUDA tensor K2 is the hand-written kernel of
``csrc/attention_bwd.cuh``; on a CPU tensor it is
`plain_attention_backward`, the same function in plain PyTorch.

`attn_bias` is the per-head additive bias shared by the batch, (T, T),
(1, T, T) or (H, T, T) in fp32 (the text tower's causal mask; JAX `has_ab`,
:113, :153-154): K1 adds it to the scores (it is part of the lse), K2 adds it
again when it recomputes p; it takes no gradient (JAX returns zeros, :392).
Any other shape raises. Head dims 64, 96, 128, 768 and 1024 run on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.random import attention_keep_mask, draw_seed, keep_threshold
from .fused_attention_block import _HEAD_DIMS, attention_forward, check_attn_bias

__all__ = ["fused_attention_block_vjp", "attention_backward", "plain_attention_backward",
           "LAUNCHES", "WIDE_LAUNCHES", "DH128_LAUNCHES", "DH1024_LAUNCHES", "BIAS_LAUNCHES"]

# wrapper calls that ran K2 on the card; those of them at a head of 768 (the
# base cascaded branches) and those with a per-head bias
LAUNCHES = 0
WIDE_LAUNCHES = 0
DH128_LAUNCHES = 0  # of them at a head of 128 (the large branches)
DH1024_LAUNCHES = 0  # of them at a head of 1024 (the fixed-K large branches)
BIAS_LAUNCHES = 0


def plain_attention_backward(qkv, key_padding_bias, dctx, ctx, lse, n_heads: int,
                             seeds=None, keep_prob: float = 1.0, attn_bias=None):
    """Plain PyTorch twin of K2: dqkv (B, T, 3D) in dctx's dtype from K1's
    fp32 qkv (q scaled), the key bias, the context cotangent, the context,
    the log-sum-exp, the dropout seeds and the per-head bias (H | 1, T, T).
    fp32 arithmetic; the dq block is the cotangent of the unscaled q
    projection."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    heads = lambda a: a.float().reshape(b, t, n_heads, dh).transpose(1, 2)
    q, k, v = (heads(a) for a in qkv.split(d, dim=-1))
    g, o = heads(dctx), heads(ctx)
    s = torch.matmul(q, k.transpose(-1, -2))
    if key_padding_bias is not None:
        s = s + key_padding_bias.float()[:, None, None, :]
    if attn_bias is not None:
        s = s + attn_bias.float()[None]
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(g, v.transpose(-1, -2))
    w = p
    if seeds is not None:
        keep = attention_keep_mask(seeds, b, n_heads, t, keep_prob)
        w = torch.where(keep, p / keep_prob, 0.0)
        dp = torch.where(keep, dp / keep_prob, 0.0)
    ds = p * (dp - (g * o).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * dh ** -0.5
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(w.transpose(-1, -2), g)
    merge = lambda a: a.transpose(1, 2).reshape(b, t, d)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dctx.dtype)


def _launch_bwd(qkv, key_padding_bias, dctx, ctx, lse, n_heads, seeds, keep_prob,
                attn_bias=None):
    global LAUNCHES, WIDE_LAUNCHES, DH128_LAUNCHES, DH1024_LAUNCHES, BIAS_LAUNCHES
    from ..utils.cuda_build import check, kernels

    b, t, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    if dh not in _HEAD_DIMS:
        raise ValueError(f"attention_backward: head dim {dh} not in {_HEAD_DIMS}")
    if dctx.dtype not in (torch.float32, torch.bfloat16) or ctx.dtype != dctx.dtype:
        raise TypeError(f"attention_backward: dctx {dctx.dtype}, ctx {ctx.dtype}")
    if qkv.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError("attention_backward: qkv and lse must be fp32")
    if tuple(dctx.shape) != (b, t, d) or tuple(ctx.shape) != (b, t, d) \
            or tuple(lse.shape) != (b, n_heads, t):
        raise ValueError(f"attention_backward: shapes qkv {tuple(qkv.shape)}, dctx "
                         f"{tuple(dctx.shape)}, ctx {tuple(ctx.shape)}, lse {tuple(lse.shape)}")
    dctx = dctx.contiguous()
    tensors = [qkv, dctx, ctx, lse] + ([] if seeds is None else [seeds])
    if any(a.device != qkv.device or not a.is_contiguous() for a in tensors):
        raise ValueError("attention_backward: inputs must be contiguous on one device")
    if key_padding_bias is None:
        key_padding_bias = torch.zeros(b, t, dtype=torch.float32, device=qkv.device)
    kb = key_padding_bias.to(torch.float32).contiguous()
    ab = None
    if attn_bias is not None:
        if attn_bias.device != qkv.device or attn_bias.ndim != 3 \
                or attn_bias.shape[0] not in (1, n_heads) or tuple(attn_bias.shape[1:]) != (t, t):
            raise ValueError(f"attention_backward: attn_bias {tuple(attn_bias.shape)} on "
                             f"{attn_bias.device}; want (1 | {n_heads}, {t}, {t}) on {qkv.device}")
        ab = attn_bias.to(torch.float32).contiguous()
    lib = kernels()
    with torch.cuda.device(qkv.device):
        dvec = torch.empty(b, n_heads, t, dtype=torch.float32, device=qkv.device)
        dqkv = torch.empty(b, t, d3, dtype=dctx.dtype, device=qkv.device)
        check(lib.sc_fab_attention_bwd(
            qkv.data_ptr(), kb.data_ptr(), None if ab is None else ab.data_ptr(),
            0 if ab is None else ab.shape[0], dctx.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), None if seeds is None else seeds.data_ptr(),
            keep_threshold(keep_prob), 1.0 / keep_prob, dh ** -0.5, dqkv.data_ptr(),
            b, t, n_heads, dh, int(dctx.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "fused_attention_block backward")
    LAUNCHES += 1
    WIDE_LAUNCHES += dh == 768
    DH128_LAUNCHES += dh == 128
    DH1024_LAUNCHES += dh == 1024
    BIAS_LAUNCHES += ab is not None
    return dqkv


def attention_backward(qkv, key_padding_bias, dctx, ctx, lse, *, n_heads: int, seeds=None,
                       keep_prob: float = 1.0, attn_bias=None):
    """K2: dqkv from the context cotangent (see `plain_attention_backward`).
    `attn_bias` (H | 1, T, T) as K1's forward took it."""
    if qkv.device.type == "cpu":
        return plain_attention_backward(qkv, key_padding_bias, dctx, ctx, lse, n_heads,
                                        seeds, keep_prob, attn_bias)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"attention_backward on {qkv.device.type}")
    return _launch_bwd(qkv, key_padding_bias, dctx, ctx, lse, n_heads, seeds, keep_prob,
                       attn_bias)


class _AttnCore(torch.autograd.Function):
    """x, Wqkv, bqkv -> ctx; the JAX `_attn_core` custom_vjp."""

    @staticmethod
    def forward(fctx, x, w_in, b_in, key_padding_bias, n_heads, seeds, keep_prob, attn_bias):
        out, qkv, lse = attention_forward(x, w_in, b_in, key_padding_bias, n_heads=n_heads,
                                          seeds=seeds, keep_prob=keep_prob, attn_bias=attn_bias)
        fctx.save_for_backward(x, w_in, key_padding_bias, qkv, lse, out, seeds, attn_bias)
        fctx.n_heads, fctx.keep_prob, fctx.b_dtype = n_heads, keep_prob, b_in.dtype
        return out

    @staticmethod
    def backward(fctx, g):
        x, w_in, kb, qkv, lse, out, seeds, ab = fctx.saved_tensors
        dqkv = attention_backward(qkv, kb, g, out, lse, n_heads=fctx.n_heads, seeds=seeds,
                                  keep_prob=fctx.keep_prob, attn_bias=ab)
        d = x.shape[-1]
        flat = dqkv.reshape(-1, 3 * d)
        # frozen projection weights (the text tower) need no weight gradient
        need_x, need_w, need_b = fctx.needs_input_grad[:3]
        dx = torch.matmul(dqkv, w_in) if need_x else None
        dw = torch.matmul(flat.t(), x.reshape(-1, d)) if need_w else None
        db = flat.float().sum(0).to(fctx.b_dtype) if need_b else None
        return dx, dw, db, None, None, None, None, None


def fused_attention_block_vjp(
    x: torch.Tensor,
    w_in: torch.Tensor, b_in: torch.Tensor,
    w_out: torch.Tensor, b_out: torch.Tensor,
    key_padding_bias: Optional[torch.Tensor] = None,
    *,
    n_heads: int,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attn_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable self-attention sub-block: x (B, T, D) and the weights in
    x's dtype, torch's (out, in) layout, key_padding_bias (B, T) fp32 ->
    ctx Woᵀ + bo (B, T, D), with gradients for x and all four weights.
    Attention dropout at `dropout_rate` when a `generator` is given.
    `attn_bias` (T, T), (1, T, T) or (H, T, T) is added to every sequence's
    scores (no gradient); any other shape raises."""
    b, t, _ = x.shape
    if attn_bias is not None:
        attn_bias = check_attn_bias(attn_bias, t, n_heads, "fused_attention_block_vjp")
        attn_bias = attn_bias.detach().to(torch.float32).contiguous()
    if key_padding_bias is None:
        key_padding_bias = torch.zeros(b, t, dtype=torch.float32, device=x.device)
    seeds, keep_prob = None, 1.0
    if dropout_rate > 0.0 and generator is not None:
        seeds, keep_prob = draw_seed(generator), 1.0 - float(dropout_rate)
    ctx = _AttnCore.apply(x.contiguous(), w_in.contiguous(), b_in,
                          key_padding_bias.to(torch.float32).contiguous(), n_heads, seeds,
                          keep_prob, attn_bias)
    return F.linear(ctx, w_out, b_out)
