"""Keyword BatchNorm (reference ``avssl/module/speechclip_c_modules/kw_bn.py``).

Port of `batch_norm_apply`, `kw_bn_dynamic` and `kw_bn_fixed` from
``speechclip_plus_tpu/ops/kw_bn.py``: torch BatchNorm1d semantics in fp32,
returned in the input dtype. In training the batch statistics normalize
(biased variance; the gradient flows through them) and the running
statistics move toward the batch's with momentum 0.1, the unbiased variance
going into `running_var` (JAX ``:53-90``); otherwise the running statistics
normalize. `kw_bn_fixed` is the fixed-K family (`Kw_BatchNorm`): one BN per
keyword (`eachKw`; fused over D*K channels when `parallel`), or one BN over D
shared by the keywords (`same`), optionally aware of the sequence lengths.

With a data-parallel `group` (``parallel/mesh.py``) the batch statistics are
those of the global batch, as in JAX's global-view step: each rank's mean and
biased variance (today's two-pass numerics) combine over the ranks by
`global_moments`, whose all-reduce carries the gradient back, and the running
variance's unbiased factor uses the global count. Padded rows count as JAX
counts them: every slot in `kw_bn_dynamic`, and the trainer's `valid=False`
pad rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import global_moments

__all__ = ["batch_norm_apply", "kw_bn_dynamic", "kw_bn_fixed"]


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5, *,
                     training: bool = False, momentum: float = 0.1,
                     sample_mask: Optional[torch.Tensor] = None, group=None
                     ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """(N, C) batch through BatchNorm1d. Returns (y, new running (mean, var)
    when training, else None). `sample_mask` (N,) bool selects the rows that
    contribute to the batch statistics (the length-aware path); `group` takes
    them over the data-parallel group's global batch."""
    xf = x.float()
    new_stats = None
    if training:
        if sample_mask is not None:
            m = sample_mask.float()[:, None]
            count = m.sum()
            n = count.clamp_min(1.0)
            mean_b = (xf * m).sum(dim=0) / n
            var_b = ((xf - mean_b) ** 2 * m).sum(dim=0) / n
            if group is not None:
                mean_b, var_b, n = global_moments(mean_b, var_b, count, group)
            unbiased = var_b.detach() * n / (n - 1.0).clamp_min(1.0)
        else:
            n = xf.shape[0]
            mean_b = xf.mean(dim=0)
            var_b = xf.var(dim=0, unbiased=False)
            if group is not None:
                mean_b, var_b, n = global_moments(mean_b, var_b, n, group)
            unbiased = var_b.detach() * n / max(n - 1, 1)
        new_stats = ((1.0 - momentum) * mean + momentum * mean_b.detach(),
                     (1.0 - momentum) * var + momentum * unbiased)
        mean, var = mean_b, var_b
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype), new_stats


def kw_bn_dynamic(keywords: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5, *,
                  training: bool = False, momentum: float = 0.1, group=None):
    """One BatchNorm over D across every (batch, slot) position of (B, T, D)
    keywords, padding included (reference `Kw_BatchNorm_dynamic`). Returns
    (y (B, T, D), new running statistics or None)."""
    b, t, d = keywords.shape
    y, new_stats = batch_norm_apply(keywords.reshape(b * t, d), scale, bias, mean, var, eps,
                                    training=training, momentum=momentum, group=group)
    return y.reshape(b, t, d), new_stats


def kw_bn_fixed(keywords: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5, *,
                batchnorm_type: str = "eachKw", parallel: bool = True, training: bool = False,
                momentum: float = 0.1, seq_lens: Optional[torch.Tensor] = None, group=None):
    """Fixed-K keyword BatchNorm on (B, K, D) keywords (reference
    `Kw_BatchNorm.forward`; JAX ``:93-169``). The channel layout of scale,
    bias and the running statistics depends on the variant:

      eachKw, parallel      (D*K,), channel = d*K + k (the (B, D, K) reshape);
      eachKw, not parallel  (K, D), one BN per keyword;
      same                  (D,), one BN over every (batch, keyword) row; with
                            `seq_lens` (B,) only positions below each length
                            contribute to the statistics and are normalized,
                            the others keep their values.

    Returns (y (B, K, D), new running statistics in that layout, or None)."""
    b, k, d = keywords.shape
    kw = dict(training=training, momentum=momentum, group=group)
    if batchnorm_type == "eachKw":
        if parallel:
            flat = keywords.transpose(1, 2).reshape(b, d * k)
            y, stats = batch_norm_apply(flat, scale, bias, mean, var, eps, **kw)
            return y.reshape(b, d, k).transpose(1, 2), stats
        # (B, K, D) normalized over the batch with (K, D) parameters: the K
        # independent BatchNorms at once
        flat = keywords.reshape(b, k * d)
        y, stats = batch_norm_apply(flat, scale.reshape(-1), bias.reshape(-1), mean.reshape(-1),
                                    var.reshape(-1), eps, **kw)
        if stats is not None:
            stats = tuple(s.reshape(k, d) for s in stats)
        return y.reshape(b, k, d), stats
    if batchnorm_type == "same":
        flat = keywords.reshape(b * k, d)
        if seq_lens is None:
            y, stats = batch_norm_apply(flat, scale, bias, mean, var, eps, **kw)
            return y.reshape(b, k, d), stats
        valid = (torch.arange(k, device=keywords.device)[None, :] < seq_lens[:, None]).reshape(-1)
        y, stats = batch_norm_apply(flat, scale, bias, mean, var, eps, sample_mask=valid, **kw)
        return torch.where(valid[:, None], y, flat).reshape(b, k, d), stats
    raise NotImplementedError(batchnorm_type)
