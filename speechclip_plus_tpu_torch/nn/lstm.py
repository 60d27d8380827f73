"""Unidirectional multi-layer LSTM with torch's parameter layout.

Port of ``speechclip_plus_tpu/nn/lstm.py``, the encoder of the APC-family
upstreams (s3prl's APC is a stack of unidirectional `torch.nn.LSTM`
layers). Each layer is one single-layer `torch.nn.LSTM` (cuDNN on the card;
JAX runs the recurrence as a `lax.scan`, outside any Pallas kernel), with
parameters `weight_ih_l0` (4H, in), `weight_hh_l0` (4H, H), `bias_ih_l0` and
`bias_hh_l0` (4H,), gate order i, f, g, o. The stack is separate layers
because every layer's output sequence is a hidden state of the upstream.

The recurrence runs in fp32 whatever the model's dtype, inputs cast to fp32
(JAX ``:48-70``), and with TF32 off: cuDNN's fp32 RNN would otherwise use
TF32 tensor cores while `torch.backends.cudnn.allow_tf32` is on (the
default), which rounds the inputs of every gate product to 10 mantissa bits
and lets the rounding accumulate through the cell state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .dropout import dropout as _dropout

__all__ = ["LSTMLayer", "LSTMStack"]


class LSTMLayer(nn.LSTM):
    """One unidirectional LSTM layer over (B, T, in) -> (B, T, H), fp32."""

    def __init__(self, in_dim: int, features: int):
        super().__init__(in_dim, features, num_layers=1, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
        try:
            return super().forward(x.float())[0]
        finally:
            cudnn.allow_tf32 = tf32


class LSTMStack(nn.Module):
    """`n_layers` stacked LSTM layers (`layer_i`); returns every layer's output
    sequence. Dropout at `dropout` between layers, in training only."""

    def __init__(self, in_dim: int, features: int, n_layers: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = float(dropout)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", LSTMLayer(in_dim if i == 0 else features, features))
        self.n_layers = n_layers

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
            outs.append(x)
            if i < self.n_layers - 1:
                x = _dropout(x, self.dropout, generator)
        return tuple(outs)
