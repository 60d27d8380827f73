"""Continuous Integrate-and-Fire.

Port of ``speechclip_plus_tpu/ops/cif.py`` (reference
``avssl/module/cif.py:24-311``) in its bin-overlap form: output bin t takes
from source frame s the overlap of the frame's alpha interval
[csum[s-1], csum[s]] with [t*thr, (t+1)*thr), so the integrate-and-fire is
one batched fp32 matmul `W @ inputs` with a static (B, MAX_FEAT_LEN, D)
output. The last bin has an open upper edge (the reference's right-index
clipping). Inference tail handling extends one fire when the residual mass
reaches the tail threshold; training (`is_inference=False`) keeps the raw
bins, and `scale_alpha` scales the alphas toward the target length first.
Gradients flow through the cumulative sums into the overlap weights, as in
JAX (torch and JAX split the gradient of min/max ties alike).
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["MAX_FEAT_LEN", "integrate_and_fire", "scale_alpha"]

MAX_FEAT_LEN = 75  # reference avssl/module/cif.py:11


def scale_alpha(alpha: torch.Tensor, target_lengths: torch.Tensor, threshold: float = 1.0,
                eps: float = 1e-5) -> torch.Tensor:
    """Train-time scaling so that sum(alpha) == threshold * target_len + eps
    (JAX ``ops/cif.py:37-49``, reference ``cif.py:127-129``)."""
    alpha_sum = alpha.sum(dim=1, keepdim=True)
    desired = threshold * target_lengths.to(alpha.dtype)[:, None] + eps
    return alpha * desired / alpha_sum.clamp_min(1e-12)


def integrate_and_fire(
    inputs: torch.Tensor,
    alpha: torch.Tensor,
    *,
    threshold: float = 1.0,
    max_feat_len: int = MAX_FEAT_LEN,
    is_inference: bool = True,
    apply_tail_handling: bool = True,
    tail_handling_firing_threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """inputs (B, S, D), alpha (B, S) nonnegative (already masked) ->
    dsample_feats (B, max_feat_len, D) in inputs' dtype, dsample_feats_length
    (B,) int32, dsample_feats_pad_mask (B, max_feat_len) bool (True = pad)."""
    b, s, _ = inputs.shape
    af = alpha.float()
    feat_lengths = torch.clamp(torch.floor(af.sum(dim=1) / threshold).to(torch.int32),
                               1, max_feat_len)
    csum = torch.cumsum(af, dim=1)
    csum_prev = csum - af

    n_bins = max_feat_len + 1  # the extra bin mirrors the reference's tail slot
    t = torch.arange(n_bins, dtype=torch.float32, device=inputs.device)
    lower = t * threshold
    upper = torch.where(t == n_bins - 1, torch.inf, (t + 1.0) * threshold)
    hi = torch.minimum(csum[:, None, :], upper[None, :, None])
    lo = torch.maximum(csum_prev[:, None, :], lower[None, :, None])
    w = torch.where(hi >= lo, hi - lo, 0.0)                     # (B, bins, S)
    output = torch.bmm(w, inputs.float())

    if is_inference and apply_tail_handling:
        tail = w.sum(dim=2).gather(1, feat_lengths.long()[:, None])[:, 0]
        extend = tail >= tail_handling_firing_threshold
        upscale = torch.where(extend, threshold / tail.clamp_min(1e-12), 1.0)
        at_tail = (torch.arange(n_bins, device=inputs.device)[None, :]
                   == feat_lengths[:, None]).float()
        output = output * (1.0 + at_tail * (upscale[:, None] - 1.0))[:, :, None]
        feat_lengths = torch.clamp(feat_lengths + extend.to(torch.int32), 1, max_feat_len)
        keep = torch.arange(max_feat_len, device=inputs.device)[None, :] < feat_lengths[:, None]
        output = output[:, :max_feat_len] * keep[:, :, None]
    else:
        output = output[:, :max_feat_len]

    pad_mask = torch.arange(max_feat_len, device=inputs.device)[None, :] >= feat_lengths[:, None]
    return {
        "dsample_feats": output.to(inputs.dtype),
        "dsample_feats_length": feat_lengths,
        "dsample_feats_pad_mask": pad_mask,
        "alpha": alpha,
    }
