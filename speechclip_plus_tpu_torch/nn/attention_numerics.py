"""The operand rounding of the tensor-core attention kernels, in plain PyTorch.

The kernels of ``csrc/attention_core.cuh`` and ``csrc/attention_bwd.cuh``
multiply on the tensor cores in TF32: each operand of a product (q, k, v, the
dropped weights, dctx, ds) is rounded to 10 explicit mantissa bits, the sums
stay fp32. Where the output is fp32 they split each operand in two TF32 parts
and add three products. This module repeats that arithmetic on any device, so
that the error it leaves can be held against the fp32 twins where no card is
at hand, and so that the kernels can be held against it on the card
(`tests/test_torch_cuda_kernels.py`). It is used by the tests only; no model
path calls it.

`emulated_attention` and `emulated_attention_backward` take what K1's
attention kernel and K2 take (the packed fp32 qkv with q scaled, the key bias,
the per-head bias, the dropout seeds) and a `mode`:

    "fp32"    plain fp32 products (the twins' arithmetic)
    "tf32"    one pass on operands rounded to TF32: bf16 outputs on the card
    "tf32x3"  the error-compensated three passes: fp32 outputs on the card
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.random import attention_keep_mask

__all__ = ["tf32_round", "split_tf32", "rounded_matmul", "emulated_attention",
           "emulated_attention_backward", "MODES", "PRECISE_ABOVE", "PRECISE_BEYOND_T"]

MODES = ("fp32", "tf32", "tf32x3")
# K2 with a bf16 cotangent at dh <= 128: a (16 own, 64 other) tile that holds a
# weight above this takes the compensated passes (csrc/attention_bwd.cuh)
PRECISE_ABOVE = 0.25
# ... and past this many keys every tile does (the one-pass error grows with T)
PRECISE_BEYOND_T = 384


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest value with 10 explicit mantissa bits, ties away
    from zero (PTX `cvt.rna.tf32.f32`), returned as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    # the magnitude is the low 31 bits: adding half of the dropped 13 bits'
    # unit and clearing them rounds it, ties away from zero; a carry runs into
    # the exponent, as it should
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo (+ a remainder near 2^-22 |x|), both exact in TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def rounded_matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in fp32 with the operands rounded as `mode` says."""
    a, b = a.float(), b.float()
    if mode == "fp32":
        return torch.matmul(a, b)
    if mode == "tf32":
        return torch.matmul(tf32_round(a), tf32_round(b))
    if mode == "tf32x3":
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        # the small terms first, as the kernel adds them
        return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)
    raise ValueError(f"mode {mode!r} not in {MODES}")


def _heads(a, b, t, n_heads):
    return a.float().reshape(b, t, n_heads, -1).transpose(1, 2)


def _scores(q, k, key_padding_bias, attn_bias, mode):
    s = rounded_matmul(q, k.transpose(-1, -2), mode)
    if key_padding_bias is not None:
        s = s + key_padding_bias.float()[:, None, None, :]
    if attn_bias is not None:
        s = s + attn_bias.float()[None]
    return s


def emulated_attention(qkv, key_padding_bias, n_heads: int, mode: str, seeds=None,
                       keep_prob: float = 1.0, attn_bias=None, scores_mode=None):
    """K1's attention kernel on the packed fp32 qkv (B, T, 3D), q scaled:
    (ctx (B, T, D) fp32, lse (B, H, T)). The softmax is fp32; the weights are
    rounded as an operand after the dropout scale and before the
    normalization, as in the kernel. `scores_mode` is the mode of q kᵀ alone
    (default: `mode`): a launch that writes the lse beside a bf16 context
    takes "tf32x3" there, because the lse is held to fp32 accuracy."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (_heads(a, b, t, n_heads) for a in qkv.split(d, dim=-1))
    s = _scores(q, k, key_padding_bias, attn_bias, scores_mode or mode)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    w = e
    if seeds is not None:
        keep = attention_keep_mask(seeds, b, n_heads, t, keep_prob)
        w = torch.where(keep, e / keep_prob, 0.0)
    ctx = rounded_matmul(w, v, mode) / l
    return ctx.transpose(1, 2).reshape(b, t, d), (m + torch.log(l)).squeeze(-1)


def _tile_max(p, rows: int, cols: int):
    """The largest p of each (rows, cols) tile of the last two dims, at every
    element of the tile."""
    n, m = p.shape[-2:]
    x = F.pad(p, (0, -m % cols, 0, -n % rows))
    tiles = x.reshape(*p.shape[:-2], x.shape[-2] // rows, rows, x.shape[-1] // cols, cols)
    top = tiles.amax(dim=(-3, -1), keepdim=True).expand_as(tiles).reshape(x.shape)
    return top[..., :n, :m]


def emulated_attention_backward(qkv, key_padding_bias, dctx, ctx, lse, n_heads: int, mode: str,
                                seeds=None, keep_prob: float = 1.0, attn_bias=None,
                                precise_above: float = PRECISE_ABOVE,
                                precise_beyond_t: int = PRECISE_BEYOND_T):
    """K2 on the same inputs as `plain_attention_backward`: dqkv (B, T, 3D)
    fp32, every one of the five products with its operands rounded.

    Under "tf32" (a bf16 cotangent, whose values `dctx` must hold; head dim
    up to 128) the precision is the kernel's, chosen per tile: a warp forms q kᵀ
    and dctx vᵀ of its (16 own, 64 other) rows in one pass, and where a weight
    of the tile exceeds `precise_above` it forms them again at fp32 accuracy
    and keeps the dropped weights unrounded in wᵀ dctx; ds k and dsᵀ q take one
    pass everywhere. Own rows are queries for dq and keys for dk and dv. Pass
    `float("inf")` to see what one pass everywhere leaves where a row's weight
    sits on a few keys. One head of 768 or more, and a sequence of more than
    `precise_beyond_t` keys, take the compensated passes in every tile."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    if dh > 128 or t > precise_beyond_t:
        precise_above = -1.0
    q, k, v = (_heads(a, b, t, n_heads) for a in qkv.split(d, dim=-1))
    g, o = _heads(dctx, b, t, n_heads), _heads(ctx, b, t, n_heads)
    dvec = (g * o).sum(-1, keepdim=True)
    keep = None if seeds is None else attention_keep_mask(seeds, b, n_heads, t, keep_prob)
    exact = "tf32x3" if mode == "tf32" else mode
    s = {m: _scores(q, k, key_padding_bias, attn_bias, m) for m in {mode, exact}}
    dp = {m: rounded_matmul(g, v.transpose(-1, -2), m) for m in {mode, exact}}

    def weights(precise):
        """(w, ds) with the first products at fp32 accuracy where `precise`."""
        p = torch.exp(torch.where(precise, s[exact], s[mode]) - lse[..., None])
        w, dpv = p, torch.where(precise, dp[exact], dp[mode])
        if keep is not None:
            w, dpv = torch.where(keep, p / keep_prob, 0.0), torch.where(keep, dpv / keep_prob, 0.0)
        return w, p * (dpv - dvec)

    if mode == "tf32":
        p_one = torch.exp(s[mode] - lse[..., None])
        by_query = _tile_max(p_one, 16, 64) > precise_above
        by_key = _tile_max(p_one, 64, 16) > precise_above
    else:
        by_query = by_key = torch.ones(b, n_heads, t, t, dtype=torch.bool, device=qkv.device)
    _, ds = weights(by_query)
    dq = rounded_matmul(ds, k, mode) * dh ** -0.5
    w, ds = weights(by_key)
    dk = rounded_matmul(ds.transpose(-1, -2), q, mode)
    if mode == "tf32":  # the cotangent is exact in TF32: the split of w makes the product exact
        dv = torch.matmul(torch.where(by_key, w, tf32_round(w)).transpose(-1, -2), g)
    else:
        dv = rounded_matmul(w.transpose(-1, -2), g, mode)
    merge = lambda a: a.transpose(1, 2).reshape(b, t, d)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
