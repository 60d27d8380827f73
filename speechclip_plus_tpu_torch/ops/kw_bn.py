"""Keyword BatchNorm (reference ``avssl/module/speechclip_c_modules/kw_bn.py``).

Port of `batch_norm_apply` and `kw_bn_dynamic` from
``speechclip_plus_tpu/ops/kw_bn.py``: torch BatchNorm1d semantics in fp32,
returned in the input dtype. In training the batch statistics normalize
(biased variance; the gradient flows through them) and the running
statistics move toward the batch's with momentum 0.1, the unbiased variance
going into `running_var` (JAX ``:53-90``); otherwise the running statistics
normalize.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["batch_norm_apply", "kw_bn_dynamic"]


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5, *,
                     training: bool = False, momentum: float = 0.1
                     ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """(N, C) batch through BatchNorm1d. Returns (y, new running (mean, var)
    when training, else None)."""
    xf = x.float()
    new_stats = None
    if training:
        n = xf.shape[0]
        mean_b = xf.mean(dim=0)
        var_b = xf.var(dim=0, unbiased=False)
        unbiased = var_b.detach() * n / max(n - 1, 1)
        new_stats = ((1.0 - momentum) * mean + momentum * mean_b.detach(),
                     (1.0 - momentum) * var + momentum * unbiased)
        mean, var = mean_b, var_b
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype), new_stats


def kw_bn_dynamic(keywords: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5, *,
                  training: bool = False, momentum: float = 0.1):
    """One BatchNorm over D across every (batch, slot) position of (B, T, D)
    keywords, padding included (reference `Kw_BatchNorm_dynamic`). Returns
    (y (B, T, D), new running statistics or None)."""
    b, t, d = keywords.shape
    y, new_stats = batch_norm_apply(keywords.reshape(b * t, d), scale, bias, mean, var, eps,
                                    training=training, momentum=momentum)
    return y.reshape(b, t, d), new_stats
