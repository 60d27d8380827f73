"""Counter-based dropout mask for the attention kernels.

The port's counterpart of ``speechclip_plus_tpu/ops/random.py`` for the
masks drawn inside kernels. The TPU kernels reseeded `pltpu.prng_seed`
streams and the backward redrew them in the same order; here the mask is a
pure function

    keep(seed, offset, b, h, i, j) = mix32(mix32(row ^ seed) ^ mix32(j + offset)) < thresh
    row = (b * H + h) * T + i,   thresh = round(keep_prob * 2**32)

(H the heads of the whole layer and h a head's index among them: a tensor-
parallel rank that holds heads [h0, h0 + H_r) draws exactly the whole mask's
rows for those heads, `head_offset` h0 and `total_heads` H.)

with `mix32` the "lowbias32" integer finalizer. It does not depend on how a
kernel tiles the (T, T) weights, so the backward (K2) regenerates the
forward's (K1) mask with no saved mask and no shared state. The CUDA side is
``csrc/dropout_mask.cuh``; the functions here compute the same bits in int64
torch ops on any device (the plain twins and the tests use them).

`draw_seed` takes (seed, offset) from an explicit `torch.Generator`, one pair
per kernel call, as an int64 tensor on the generator's device: the kernels
read it from device memory, so drawing it never waits for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mix32", "keep_threshold", "draw_seed", "attention_keep_mask"]

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(keep_prob: float) -> int:
    """uint32 threshold: a draw below it keeps the element."""
    return min(int(round(float(keep_prob) * 2.0 ** 32)), 2 ** 32 - 1)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """(2,) int64 [seed, offset] in [0, 2**32) on the generator's device."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator, dtype=torch.int64,
                         device=generator.device)


def attention_keep_mask(seeds: torch.Tensor, b: int, h: int, t: int,
                        keep_prob: float, head_offset: int = 0,
                        total_heads: Optional[int] = None) -> torch.Tensor:
    """(b, h, t, t) bool keep mask on `seeds`' device for attention weights
    of b sequences, h heads, t queries and keys: heads [head_offset,
    head_offset + h) of a layer of `total_heads` (default h)."""
    total = h if total_heads is None else int(total_heads)
    if not 0 <= head_offset <= total - h:
        raise ValueError(f"attention_keep_mask: heads [{head_offset}, {head_offset + h}) "
                         f"of {total}")
    if b * total * t >= 2 ** 32:
        raise ValueError(f"attention_keep_mask: {b}*{total}*{t} rows exceed 32 bits")
    seed, offset = (int(v) for v in seeds.tolist())
    dev = seeds.device
    heads = torch.arange(head_offset, head_offset + h, dtype=torch.int64, device=dev)
    rows = ((torch.arange(b, dtype=torch.int64, device=dev)[:, None] * total
             + heads[None, :])[:, :, None] * t
            + torch.arange(t, dtype=torch.int64, device=dev)[None, None, :])[..., None]
    cols = torch.arange(t, dtype=torch.int64, device=dev)
    row_key = mix32(rows ^ seed)
    col_key = mix32((cols + offset) & _MASK32)
    return mix32(row_key ^ col_key) < keep_threshold(keep_prob)
