"""Vector quantization onto the CLIP subword codebook, eval (hard) form.

Port of `simple_vector_quantizer` from ``speechclip_plus_tpu/ops/vq.py``
(reference ``my_vector_quantizer.py:12-165``) for the materialized (B, T, V)
score tensor: special-token columns masked to -1e30, hard argmax, codebook
statistics. The serving path never builds that tensor: the keyword head
takes the fused form (`ops/fused_keyword.py`, K3), whose plain twin computes
the same targets and statistics. Training (straight-through, Gumbel) comes
with the training step.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

__all__ = ["simple_vector_quantizer"]

_MASK_VALUE = -1e30


def simple_vector_quantizer(
    x: torch.Tensor,
    *,
    temp,
    prob_msk: Sequence[int] = (0, 2, 3),
    codebook: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """x: (B, T, V) cosine scores. Returns code/prob perplexity, ent_per_t
    (T,), diversity_loss, temp, targets (B, T, 1) and, with a (V, D)
    `codebook`, keywords = codebook[targets] (fp32)."""
    b, t, v = x.shape
    flat = x.reshape(b * t, v).float()
    if len(prob_msk) > 0:
        special = torch.zeros(v, dtype=torch.bool, device=x.device)
        special[[int(i) for i in prob_msk if 0 <= int(i) < v]] = True
        flat = flat.masked_fill(special[None, :], _MASK_VALUE)
    k = torch.argmax(flat, dim=-1)
    perplexity = lambda p: torch.exp(-(p * torch.log(p + 1e-7)).sum())
    hard_probs = torch.bincount(k, minlength=v).float() / (b * t)
    soft = torch.softmax(flat, dim=-1)
    result = {
        "num_vars": v,
        "code_perplexity": perplexity(hard_probs),
        "prob_perplexity": perplexity(soft.mean(dim=0)),
        "ent_per_t": (-(soft * torch.log(soft + 1e-9)).sum(dim=-1)).reshape(b, t).mean(dim=0),
        "temp": torch.as_tensor(temp, dtype=torch.float32, device=x.device),
        "targets": k.reshape(b, t, 1),
    }
    result["diversity_loss"] = (v - result["prob_perplexity"]) / v
    if codebook is not None:
        result["keywords"] = codebook.float()[k].reshape(b, t, -1)
    return result
