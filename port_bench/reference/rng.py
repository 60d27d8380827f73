"""The random streams a training step of the measured program draws, rebuilt.

A frozen copy, kept with the benchmark, of the program's published scheme:

  - the generator of micro-step s is seeded from numpy's SeedSequence over
    (seed & 0xFFFFFFFF, s), on the device the step runs on;
  - a dropout of activations is `bernoulli_(1 - p, generator=g)` on a tensor
    of the activation's shape, kept elements scaled by 1 / (1 - p);
  - a dropout of attention weights draws one (seed, offset) pair,
    `randint(0, 2**32, (2,))` in int64, and keeps weight (b, h, i, j) when
    mix32(mix32(row ^ seed) ^ mix32(j + offset)) < round(keep * 2**32), with
    row = (b * H + h) * T + i and mix32 the "lowbias32" finalizer.

Nothing here imports the program; the reference draws from the generators in
the order the model's layers use them, so both see the same masks.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["step_generator", "draw_seed", "keep_mask", "bernoulli_keep"]

_M32 = 0xFFFFFFFF


def step_generator(seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed) & _M32, int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def draw_seed(gen: torch.Generator):
    pair = torch.randint(0, 2 ** 32, (2,), generator=gen, dtype=torch.int64, device=gen.device)
    return tuple(int(v) for v in pair.tolist())


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(pair, b0: int, b1: int, heads: int, t: int, keep: float, device) -> torch.Tensor:
    """(b1 - b0, heads, t, t) bool: the kept attention weights of sequences
    [b0, b1) of a batch."""
    seed, offset = pair
    b = torch.arange(b0, b1, dtype=torch.int64, device=device)
    h = torch.arange(heads, dtype=torch.int64, device=device)
    i = torch.arange(t, dtype=torch.int64, device=device)
    rows = ((b[:, None] * heads + h[None, :])[:, :, None] * t + i[None, None, :])[..., None]
    row_key = _mix32(rows ^ seed)
    col_key = _mix32((i + offset) & _M32)
    thresh = min(int(round(keep * 2.0 ** 32)), 2 ** 32 - 1)
    return _mix32(row_key ^ col_key) < thresh


def bernoulli_keep(shape, p: float, gen: torch.Generator) -> torch.Tensor:
    """The scaled keep mask of an activation dropout at rate p."""
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=torch.float32, device=gen.device).bernoulli_(keep,
                                                                                 generator=gen)
    return mask / keep
