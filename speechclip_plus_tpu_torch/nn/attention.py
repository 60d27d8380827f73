"""Multi-head attention with torch's packed in-proj layout.

Port of ``speechclip_plus_tpu/nn/attention.py``. Parameters follow
torch.nn.MultiheadAttention: `in_proj_weight` (3D, D), `in_proj_bias` (3D,),
`out_proj` Linear(D, D). q is scaled by 1/sqrt(dh) before q kᵀ.

Parameters are stored in `dtype` and cast to `compute_dtype` inside
`forward`, as flax's `dtype=` does: the trainable branch stores fp32 master
weights and computes in bf16 under `trainer.precision: bf16`; the frozen
towers store and compute in one dtype. The fp32 `in_proj_bias` reaches the
kernels uncast (the TPU kernel added an fp32 bias, JAX
``nn/fused_attention_block_vjp.py:468``).

Self-attention without a per-head mask goes through the fused attention
block (K1, ``nn/fused_attention_block.py``): forward-only with the
out-projection fused in for the frozen towers (`fuse_out=True`), or the
differentiable context-only block with its backward kernel (K2,
``nn/fused_attention_block_vjp.py``) for the branch (`fuse_out=False`).
Attention dropout at `dropout` runs inside the kernels when a generator is
passed. The route switch is JAX's (``:134-139``): a module built with
`fuse_out=False` (JAX `fused_block_vjp`) takes K1 + K2 for self-attention
with no mask or a 2-D one (the mask becomes the kernels' per-head bias, as
the CLIP text tower's causal mask does behind `clip.text_fused_attention_vjp`);
a mask of more dims, a `fuse_out=True` module given a mask (the text tower by
default), and `return_weights` (attention maps) take the plain path with
plain autograd; so does every call of a module built with `kernel=False` (a
trainable tower's layers, the branch under
`model_settings.fused_attention_vjp: false`), attention dropout included.
`attn_bias` with an optional `attn_gate` (WavLM's gated
relative position bias) rides inside K1; without a gate it also rides K1 + K2
in the context-only route, where a shape other than (T, T), (1, T, T) or
(H, T, T) raises.

The acoustic tower's other routes compute the projections outside any kernel,
as the JAX package does: `project_qkv` returns q, k, v as (B, H, T, dh)
strided views of one packed (B, T, 3D) projection (no transpose copy), the
attention runs as K5 (``nn/fused_attention.py``), K4 (``nn/flash.py``) or
`dot_product_attention`, and `project_out` merges the heads and applies the
out-projection.

Tensor parallelism (``parallel/tp.py``) shards the acoustic tower's
attention by head: `shard_model` leaves this rank's heads in `in_proj_*` and
their columns in `out_proj.weight` and sets `tp`. The fused-out route then
runs K1 on the rank's heads and sums its fp32 partial out-projections over
the model group before the bias; `project_qkv` gives the rank's heads and
`project_out` the summed row-parallel product. Dropout masks are keyed by
the layer's head index, so a shard drops what the whole layer drops.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.random import attention_keep_mask, draw_seed
from ..parallel.tp import copy_to_model, reduce_from_model, row_parallel_linear
from .fused_attention_block import fused_attention_block
from .fused_attention_block_vjp import fused_attention_block_vjp

__all__ = ["MultiheadAttention", "dot_product_attention", "padding_bias"]

_MASK_VALUE = -1e30


def padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool, True = pad -> additive fp32 bias, -1e30 at pads."""
    return torch.where(key_padding_mask, _MASK_VALUE, 0.0).to(torch.float32)


def dot_product_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          return_weights: bool = False, head_offset: int = 0,
                          total_heads: Optional[int] = None):
    """Scaled dot-product attention on (B, H, T, dh), q scaled inside.

    bf16 inputs keep bf16 scores and probabilities (the JAX XLA path's
    precision); the softmax itself runs in fp32. `bias` broadcasts to
    (B, H, Tq, Tk). With a `generator`, the weights are dropped at
    `dropout_rate` with the counter mask of ``ops/random.py`` (self-attention
    only: Tq == Tk), the H heads being heads [head_offset, head_offset + H)
    of `total_heads`. `return_weights` also returns the undropped weights."""
    q = q * (q.shape[-1] ** -0.5)
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and generator is not None:
        b, h, t, _ = q.shape
        keep_prob = 1.0 - float(dropout_rate)
        keep = attention_keep_mask(draw_seed(generator), b, h, t, keep_prob, head_offset,
                                   total_heads)
        dropped = torch.where(keep, weights / keep_prob, 0.0)
        return (torch.matmul(dropped, v), weights) if return_weights \
            else torch.matmul(dropped, v)
    out = torch.matmul(weights, v)
    return (out, weights) if return_weights else out


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, *, fuse_out: bool = True,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.0,
                 kernel: bool = True):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.d_model, self.nhead, self.fuse_out, self.kernel = d_model, nhead, fuse_out, kernel
        self.compute_dtype = compute_dtype or dtype
        self.dropout = float(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, dtype=dtype))
        self.out_proj = nn.Linear(d_model, d_model, dtype=dtype)
        self.tp = None  # the model group when sharded by head (parallel/tp.py)

    def head_range(self):
        """(this module's heads, the first one's index, the layer's heads):
        (nhead, 0, nhead) unless sharded by head."""
        dh = self.d_model // self.nhead
        h = self.in_proj_weight.shape[0] // (3 * dh)
        return h, (0 if self.tp is None else self.tp.model_rank * h), self.nhead

    def project_qkv(self, x: torch.Tensor):
        """q, k, v (B, H, T, dh) in the compute dtype: strided views of one
        packed (B, T, 3D) projection, q unscaled (this rank's heads when
        sharded)."""
        cd = self.compute_dtype
        b, t, d = x.shape
        x = copy_to_model(x.to(cd), self.tp)
        qkv = F.linear(x, self.in_proj_weight.to(cd), self.in_proj_bias.to(cd))
        h = self.head_range()[0]
        return qkv.view(b, t, 3, h, d // self.nhead).permute(2, 0, 3, 1, 4).unbind(0)

    def project_out(self, ctx: torch.Tensor) -> torch.Tensor:
        """(B, H, T, dh) per-head context -> out-projected (B, T, D); sharded,
        the row-parallel product summed over the model group."""
        cd = self.compute_dtype
        b, h, t, dh = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, t, h * dh)
        if self.tp is not None:
            return row_parallel_linear(ctx, self.out_proj.weight.to(cd),
                                       self.out_proj.bias.to(cd), self.tp, cd)
        return F.linear(ctx, self.out_proj.weight.to(cd), self.out_proj.bias.to(cd))

    def forward(self, x: torch.Tensor, key_padding_bias: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                attn_bias: Optional[torch.Tensor] = None,
                attn_gate: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        """x (B, T, D) -> (B, T, D) in the compute dtype.
        key_padding_bias: (B, T) fp32 additive (`padding_bias`).
        attn_mask: additive fp32 mask broadcastable to (B, H, T, T).
        generator: attention dropout at `self.dropout` (None: none).
        attn_bias, attn_gate: the kernels' per-head bias (T, T) or (H | 1, T, T)
        and its (B, H, T) gate (the gate in the fused-out block only).
        return_weights: also the (B, H, T, T) attention weights (plain path)."""
        cd = self.compute_dtype
        x = x.to(cd)
        w_in = self.in_proj_weight.to(cd)
        w_out, b_out = self.out_proj.weight.to(cd), self.out_proj.bias.to(cd)
        if attn_bias is not None and attn_mask is not None:
            raise ValueError("attn_bias and attn_mask are one additive term: pass one")
        if attn_gate is not None and (attn_bias is None or not self.fuse_out or return_weights):
            raise NotImplementedError("attn_gate outside the fused-out block")
        if self.tp is not None:
            if not (self.kernel and self.fuse_out and attn_mask is None and not return_weights):
                raise NotImplementedError("a head-sharded attention takes K1 fused-out or "
                                          "project_qkv / project_out")
            h, h0, total = self.head_range()
            part = fused_attention_block(
                x.contiguous(), w_in, self.in_proj_bias, w_out, b_out, key_padding_bias,
                n_heads=h, fuse_out=True, dropout_rate=self.dropout, generator=generator,
                attn_bias=attn_bias, attn_gate=attn_gate, head_offset=h0, total_heads=total,
                partial=True)
            return (reduce_from_model(part, self.tp) + b_out.float()).to(cd)
        if self.kernel and not return_weights:
            if self.fuse_out and attn_mask is None:
                return fused_attention_block(
                    x.contiguous(), w_in, self.in_proj_bias, w_out, b_out, key_padding_bias,
                    n_heads=self.nhead, fuse_out=True, dropout_rate=self.dropout,
                    generator=generator, attn_bias=attn_bias, attn_gate=attn_gate)
            if not self.fuse_out and (attn_mask is None or attn_mask.ndim == 2):
                return fused_attention_block_vjp(
                    x.contiguous(), w_in, self.in_proj_bias, w_out, b_out, key_padding_bias,
                    n_heads=self.nhead, dropout_rate=self.dropout, generator=generator,
                    attn_bias=attn_mask if attn_bias is None else attn_bias)
        if attn_gate is not None:
            raise NotImplementedError("attn_gate on the plain path (HubertEncoderLayer gates "
                                      "the bias itself)")
        b, t, d = x.shape
        q, k, v = F.linear(x, w_in, self.in_proj_bias.to(cd)).split(d, dim=-1)
        split = lambda a: a.reshape(b, t, self.nhead, -1).transpose(1, 2)
        bias = attn_mask if attn_bias is None else attn_bias
        bias = None if bias is None else bias.float()
        if key_padding_bias is not None:
            kb = key_padding_bias[:, None, None, :]
            bias = kb if bias is None else bias + kb
        out = dot_product_attention(split(q), split(k), split(v), bias, self.dropout, generator,
                                    return_weights=return_weights)
        if return_weights:
            out, weights = out
        out = F.linear(out.transpose(1, 2).reshape(b, t, d), w_out, b_out)
        return (out, weights) if return_weights else out
