"""Dropout with an explicit generator.

Port of `FastDropout` (``speechclip_plus_tpu/nn/dropout.py``). The TPU's
8-bit dithered keep masks stay behind: the mask is `bernoulli_(keep,
generator=g)`, and the JAX "dropout" RNG collection becomes the generator the
caller passes down. `generator=None` means deterministic (no dropout), the
port's spelling of flax's `deterministic=True`.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout"]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: kept elements scaled by 1/(1 - rate)."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(
        keep, generator=generator)
    return x * mask / keep
