"""MLP projection stack (reference ``avssl/module/projections.py:6-29``).

Port of `MLPLayers` (``speechclip_plus_tpu/nn/mlp.py``): Linear, ReLU and
dropout repeated over `units`, without the trailing ReLU and dropout. fp32
master weights computed in `compute_dtype`; a `generator` turns the dropout
on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout

__all__ = ["MLPLayers"]


class MLPLayers(nn.Module):
    def __init__(self, units: Sequence[int], dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.compute_dtype = float(dropout), compute_dtype
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(units[:-1], units[1:]))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(cd), layer.bias.to(cd))
            if i < len(self.layers) - 1:
                x = dropout(torch.relu(x), self.dropout, generator)
        return x
