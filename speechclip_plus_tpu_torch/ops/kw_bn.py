"""Keyword BatchNorm, eval mode (reference
``avssl/module/speechclip_c_modules/kw_bn.py``). Port of `batch_norm_apply`
and `kw_bn_dynamic` from ``speechclip_plus_tpu/ops/kw_bn.py``: torch
BatchNorm1d with running statistics, computed in fp32, returned in the input
dtype. Train-time statistics come with the training step."""
from __future__ import annotations

import torch

__all__ = ["batch_norm_apply", "kw_bn_dynamic"]


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, C) batch through BatchNorm1d with running statistics."""
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def kw_bn_dynamic(keywords: torch.Tensor, scale, bias, mean, var,
                  eps: float = 1e-5) -> torch.Tensor:
    """One BatchNorm over D across every (batch, slot) position of (B, T, D)
    keywords, padding included (reference `Kw_BatchNorm_dynamic`)."""
    b, t, d = keywords.shape
    return batch_norm_apply(keywords.reshape(b * t, d), scale, bias, mean, var,
                            eps).reshape(b, t, d)
