"""Softmax weights of the learnable sum over encoder hidden layers
(reference ``avssl/module/weighted_sum.py:10-45``; JAX
``speechclip_plus_tpu/ops/weighted_sum.py``).

The port never stacks the (L, B, T, D) hidden states: the HuBERT tower
accumulates `sum_i w_i h_i` inside its layer loop with these weights
(``models/hubert.py``).
"""
from __future__ import annotations

import torch

__all__ = ["layer_weights"]


def layer_weights(logits: torch.Tensor) -> torch.Tensor:
    """(L,) learnable logits -> fp32 softmax weights."""
    return torch.softmax(logits.float(), dim=0)
