"""Branch transformer blocks and the shared LayerNorm.

Port of ``speechclip_plus_tpu/nn/transformer.py`` (reference
``TransformerModels.py``): `MultiheadAttentionAndNorm` (:100-136), one MHA +
residual + LayerNorm, with `extract_attention_map`; `TransformerEncoderLayer`
(torch's, batch-first, post- or pre-norm, exact-erf GELU FFN, three dropouts)
and `TransformerEncoder` (:47-97), a stack of them plus a final LayerNorm,
with `extract_hidden_states`. Every branch self-attention is the
differentiable fused attention block in context-only mode (K1 forward, K2
backward), with attention dropout at the config's rate (0.1) in training; the
out-projection after it is a plain ``ctx @ Wo + bo``. A frozen tower's layer
(`fuse_out=True`) takes K1 with the out-projection fused in instead;
`kernel=False` takes the plain attention with its dropout
(`model_settings.fused_attention_vjp: false`, a trainable mel tower).
Attention maps take the plain path. Parameters are fp32 master weights
computed in `compute_dtype` (flax `dtype=`). Under tensor parallelism
(``parallel/tp.py`` sets a layer's `tp`) the FFN's `linear1` is
column-parallel and `linear2` row-parallel; the dropout between them draws
the whole-width mask and keeps this rank's columns, so the draws and the
mask are the unsharded step's. The attention stays replicated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tp import copy_to_model, dropout_columns, row_parallel_linear
from .attention import MultiheadAttention, padding_bias
from .dropout import dropout

__all__ = ["LayerNorm", "MultiheadAttentionAndNorm", "TransformerEncoderLayer",
           "TransformerEncoder"]

_ACT = {"relu": torch.relu, "gelu": F.gelu}  # F.gelu: exact erf, torch's default


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
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 kernel: bool = True):
        super().__init__()
        self.multihead_attn_layer = MultiheadAttention(
            d_model, nhead, fuse_out=False, compute_dtype=compute_dtype, dropout=dropout,
            kernel=kernel)
        self.attentionBlock_Norm = LayerNorm(d_model, eps=layer_norm_eps,
                                             compute_dtype=compute_dtype)

    def forward(self, src: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
        out = self.multihead_attn_layer(src, key_padding_bias=bias, generator=generator)
        # the residual add promotes to src's dtype (fp32 tower features), as in JAX
        return self.attentionBlock_Norm(out + src)

    def extract_hidden_states(self, src: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
        return (src, self(src, key_padding_mask))

    def extract_attention_map(self, src: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None):
        """(output, attention weights (B, H, T, T)), deterministic."""
        bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
        out, weights = self.multihead_attn_layer(src, key_padding_bias=bias,
                                                 return_weights=True)
        return self.attentionBlock_Norm(out + src), weights


class TransformerEncoderLayer(nn.Module):
    """torch `nn.TransformerEncoderLayer` (batch-first): self-attention and a
    two-layer FFN, each with dropout and a residual; LayerNorm after
    (post-norm) or before (`norm_first`) each. `fuse_out=True` is a frozen
    tower's layer (the mel transformers): K1 with the out-projection fused
    in, forward only, in place of the differentiable K1 + K2 route."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 3072,
                 dropout: float = 0.1, activation: str = "gelu", layer_norm_eps: float = 1e-5,
                 norm_first: bool = False, compute_dtype: torch.dtype = torch.float32,
                 fuse_out: bool = False, kernel: bool = True):
        super().__init__()
        self.dropout, self.norm_first = float(dropout), norm_first
        self.compute_dtype = compute_dtype
        self.act = _ACT[activation]
        self.self_attn = MultiheadAttention(d_model, nhead, fuse_out=fuse_out,
                                            compute_dtype=compute_dtype, dropout=dropout,
                                            kernel=kernel)
        self.norm1 = LayerNorm(d_model, eps=layer_norm_eps, compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(d_model, eps=layer_norm_eps, compute_dtype=compute_dtype)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.tp = None  # the model group when the FFN is sharded

    def _sa(self, x, bias, generator):
        return dropout(self.self_attn(x, key_padding_bias=bias, generator=generator),
                       self.dropout, generator)

    def _ff(self, x, generator):
        cd, l1, l2 = self.compute_dtype, self.linear1, self.linear2
        if self.tp is not None:
            h = self.act(F.linear(copy_to_model(x.to(cd), self.tp), l1.weight.to(cd),
                                  l1.bias.to(cd)))
            width = h.shape[-1]
            h = dropout_columns(h, self.dropout, generator, width * self.tp.model_world,
                                width * self.tp.model_rank)
            h = row_parallel_linear(h, l2.weight.to(cd), l2.bias.to(cd), self.tp, cd)
            return dropout(h, self.dropout, generator)
        h = self.act(F.linear(x.to(cd), l1.weight.to(cd), l1.bias.to(cd)))
        h = F.linear(dropout(h, self.dropout, generator), l2.weight.to(cd), l2.bias.to(cd))
        return dropout(h, self.dropout, generator)

    def forward(self, src: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
        if self.norm_first:
            src = src + self._sa(self.norm1(src), bias, generator)
            return src + self._ff(self.norm2(src), generator)
        src = self.norm1(src + self._sa(src, bias, generator))
        return self.norm2(src + self._ff(src, generator))


class TransformerEncoder(nn.Module):
    """A stack of encoder layers and the final LayerNorm(eps 1e-5)."""

    def __init__(self, n_layers: int = 1, d_model: int = 768, nhead: int = 8,
                 dim_feedforward: int = 3072, dropout: float = 0.1, activation: str = "gelu",
                 layer_norm_eps: float = 1e-5, norm_first: bool = False,
                 compute_dtype: torch.dtype = torch.float32, kernel: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, activation,
                                    layer_norm_eps, norm_first, compute_dtype, kernel=kernel)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, eps=1e-5, compute_dtype=compute_dtype)

    def forward(self, src: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, key_padding_mask, generator)
        return self.norm(src)

    def extract_hidden_states(self, src: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
        """(input, after layer 1, ..., after layer N), before the final norm."""
        hidden = [src]
        for layer in self.layers:
            hidden.append(layer(hidden[-1], key_padding_mask))
        return tuple(hidden)
