"""Branch transformer block and the shared LayerNorm.

Port of `MultiheadAttentionAndNorm` from ``speechclip_plus_tpu/nn/transformer.py``
(reference ``TransformerModels.py:100-136``): one MHA + residual + LayerNorm.
Its self-attention runs through the fused attention block in context-only
mode (K1); the out-projection after it is a plain ``ctx @ Wo + bo``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiheadAttention, padding_bias

__all__ = ["LayerNorm", "MultiheadAttentionAndNorm"]


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics run in fp32 whatever the input dtype; the
    output is in the module's parameter dtype (flax `LayerNorm(dtype=...)`)."""

    def __init__(self, d: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=eps, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.weight.dtype)


class MultiheadAttentionAndNorm(nn.Module):
    def __init__(self, d_model: int = 768, nhead: int = 8, layer_norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.multihead_attn_layer = MultiheadAttention(d_model, nhead, fuse_out=False,
                                                       dtype=dtype)
        self.attentionBlock_Norm = LayerNorm(d_model, eps=layer_norm_eps, dtype=dtype)

    def forward(self, src: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
        out = self.multihead_attn_layer(src, key_padding_bias=bias)
        # the residual add promotes to src's dtype (fp32 tower features), as in JAX
        return self.attentionBlock_Norm(out + src)
