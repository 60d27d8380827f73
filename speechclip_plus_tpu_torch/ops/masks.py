"""Key-padding mask (reference ``avssl/util/data_utils.py:6-22``; JAX
``speechclip_plus_tpu/ops/masks.py``): boolean, True = PAD."""
from __future__ import annotations

import torch

__all__ = ["get_keypadding_mask"]


def get_keypadding_mask(max_length: int, lengths: torch.Tensor) -> torch.Tensor:
    """Boolean (B, max_length) mask, True at padded positions (i >= length)."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return pos >= lengths.to(torch.long)[:, None]
