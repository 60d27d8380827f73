"""Softmax-weighted sum over encoder hidden layers (reference
``avssl/module/weighted_sum.py:10-45``; JAX
``speechclip_plus_tpu/ops/weighted_sum.py``).

Where the feature is the plain or s3prl-normalized weighted sum, the HuBERT
tower accumulates `sum_i w_i h_i` inside its layer loop with `layer_weights`
and never stacks the (L, B, T, D) hidden states (``models/hubert.py``).
`weighted_sum` is the stacked route, for the features that need the whole
stack first (`normalize_type` method1 / method2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layer_weights", "layer_norm", "weighted_sum"]


def layer_weights(logits: torch.Tensor) -> torch.Tensor:
    """(L,) learnable logits -> fp32 softmax weights."""
    return torch.softmax(logits.float(), dim=0)


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free layer norm over the last axis, in x's dtype."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def weighted_sum(hidden_states: torch.Tensor, weights: torch.Tensor,
                 normalize_features: bool = False) -> torch.Tensor:
    """Softmax(`weights`)-weighted sum of the stacked (L, ...) hidden states
    over the layer axis, each feature vector layer-normed first when
    `normalize_features`."""
    if hidden_states.shape[0] != weights.shape[0]:
        raise ValueError(f"weighted_sum: {tuple(hidden_states.shape)} hidden states, "
                         f"{tuple(weights.shape)} weights")
    x = layer_norm(hidden_states) if normalize_features else hidden_states
    w = layer_weights(weights).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return (w * x).sum(dim=0)
