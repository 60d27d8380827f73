"""Contrastive and CIF quantity objectives.

Port of `masked_contrastive_loss`, `supcon_loss` and `quantity_l1_loss` from
``speechclip_plus_tpu/ops/losses.py`` (reference ``avssl/module/losses.py:8-245``
and torch `nn.L1Loss`): symmetric InfoNCE over the B x B similarity matrix
with id-aware negatives (captions of the same image are not negatives), an
optional margin and decoupled (DCL) variant, an optional `valid` row mask for
padded batch rows, and a numerically stable masked log-sum-exp; the
supervised contrastive loss over views (`cl_loss.type: SupConLoss`).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["masked_contrastive_loss", "supcon_loss", "quantity_l1_loss"]

_NEG_INF = -1e30


def _masked_logsumexp(logits: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(logits) * mask)) along `dim`, max-subtracted."""
    masked = torch.where(mask, logits, _NEG_INF)
    m = masked.max(dim=dim, keepdim=True).values.detach()
    return torch.log(torch.exp(masked - m).sum(dim=dim)) + m.squeeze(dim)


def masked_contrastive_loss(feat_a: torch.Tensor, feat_b: torch.Tensor,
                            ids: Optional[torch.Tensor] = None, *, logit_scale,
                            margin: float = 0.0, dcl: bool = False, a2b: bool = True,
                            b2a: bool = True, valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """feat_a, feat_b (B, D) L2-normalized; ids (B,) pair ids (equal ids are
    never negatives); logit_scale the multiplier on the similarities; valid
    (B,) bool excludes rows and columns. Returns the fp32 scalar loss."""
    if feat_a.shape != feat_b.shape:
        raise ValueError(f"feature shapes {tuple(feat_a.shape)} vs {tuple(feat_b.shape)}")
    if not (a2b or b2a):
        raise ValueError("a2b and b2a cannot both be False")
    b = feat_a.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=feat_a.device)
    neg_mask = ids.reshape(b, 1) != ids.reshape(1, b) if ids is not None else ~eye
    if not dcl:
        neg_mask = neg_mask | eye
    if valid is not None:
        neg_mask = neg_mask & (valid[:, None] & valid[None, :])
        denom = valid.sum().clamp_min(1).float()
    else:
        denom = float(b)
    logits = (feat_a.float() @ feat_b.float().T) * logit_scale
    if margin > 0.0:
        logits = logits - margin * eye.float()
    pos = torch.diagonal(logits)
    loss, n_terms = 0.0, 0
    for use, dim in ((a2b, 1), (b2a, 0)):
        if use:
            per = -pos + _masked_logsumexp(logits, neg_mask, dim)
            if valid is not None:
                per = torch.where(valid, per, 0.0)
            loss = loss + per.sum() / denom
            n_terms += 1
    return loss / n_terms


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, *, temperature,
                base_temperature: float = 0.07, contrast_mode: str = "all",
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised contrastive loss (reference ``losses.py:46-123``, JAX
    ``:137-210``). features (B, n_views, D); labels (B,) (samples of one label
    are positives) or mask (B, B); temperature the divisor of the logits;
    valid (B,) bool excludes padded rows as anchors and as contrasts."""
    if features.dim() != 3:
        raise ValueError("features must be [bsz, n_views, ...]")
    b, n_views = features.shape[:2]
    dev = features.device
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(b, dtype=torch.float32, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = mask.float()
    contrast = features.transpose(0, 1).reshape(b * n_views, -1)
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, n_views
    else:
        raise ValueError(f"Unknown mode: {contrast_mode}")
    logits = (anchor @ contrast.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, n_views)
    logits_mask = 1.0 - torch.eye(b * anchor_count, b * n_views, device=dev)
    if valid is not None:
        logits_mask = logits_mask * valid.float().repeat(n_views)[None, :]
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True).clamp_min(1e-12))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-12)
    per_anchor = (-(1.0 / base_temperature) * mean_log_prob_pos).reshape(anchor_count, b)
    if valid is None:
        return per_anchor.mean()
    v = valid.float()
    return (per_anchor * v[None, :]).sum() / (anchor_count * v.sum()).clamp_min(1.0)


def quantity_l1_loss(quantity_out: torch.Tensor, target_len: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean |sum(alpha) - target_len| over the (valid) rows."""
    err = (quantity_out - target_len.to(quantity_out.dtype)).abs()
    if valid is None:
        return err.mean()
    v = valid.to(err.dtype)
    return (err * v).sum() / v.sum().clamp_min(1.0)
