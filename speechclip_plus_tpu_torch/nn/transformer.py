"""Branch transformer block and the shared LayerNorm.

Port of `MultiheadAttentionAndNorm` from ``speechclip_plus_tpu/nn/transformer.py``
(reference ``TransformerModels.py:100-136``): one MHA + residual + LayerNorm.
Its self-attention is the differentiable fused attention block in
context-only mode (K1 forward, K2 backward), with attention dropout at the
config's rate (0.1) in training; the out-projection after it is a plain
``ctx @ Wo + bo``. Parameters are fp32 master weights computed in
`compute_dtype` (flax `dtype=`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiheadAttention, padding_bias

__all__ = ["LayerNorm", "MultiheadAttentionAndNorm"]


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics run in fp32 whatever the input dtype, with
    parameters in `dtype`; the output is in `compute_dtype` (default: the
    parameter dtype), as flax `LayerNorm(dtype=...)` with fp32 params."""

    def __init__(self, d: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(d, eps=eps, dtype=dtype)
        self.compute_dtype = compute_dtype or dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.compute_dtype)


class MultiheadAttentionAndNorm(nn.Module):
    def __init__(self, d_model: int = 768, nhead: int = 8, layer_norm_eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.multihead_attn_layer = MultiheadAttention(
            d_model, nhead, fuse_out=False, compute_dtype=compute_dtype, dropout=dropout)
        self.attentionBlock_Norm = LayerNorm(d_model, eps=layer_norm_eps,
                                             compute_dtype=compute_dtype)

    def forward(self, src: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
        out = self.multihead_attn_layer(src, key_padding_bias=bias, generator=generator)
        # the residual add promotes to src's dtype (fp32 tower features), as in JAX
        return self.attentionBlock_Norm(out + src)
