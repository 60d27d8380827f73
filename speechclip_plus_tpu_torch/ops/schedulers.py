"""Learning-rate schedules, stepped per optimizer step.

Port of ``speechclip_plus_tpu/ops/schedulers.py`` (reference
``avssl/optim/scheduler.py:10-47``): functions of the optimizer step that
return the learning rate. `linear_warmup_decay` is floored at `final_lr`, as
in JAX: the reference's LambdaLR goes negative past `max_step`, which a
resumed run with a longer `trainer.max_steps` would hit.
"""
from __future__ import annotations

import math
from typing import Callable

__all__ = ["noam_schedule", "linear_warmup_decay_schedule", "get_schedule"]


def noam_schedule(base_lr: float, warmup: int = 4000) -> Callable[[int], float]:
    """lr(step) = base_lr * min((step+1)/warmup, sqrt(warmup/(step+1)))."""

    def schedule(step: int) -> float:
        s = float(step) + 1.0
        return base_lr * (s / warmup if step < warmup else math.sqrt(warmup / s))

    return schedule


def linear_warmup_decay_schedule(base_lr: float, warmup: int = 4000,
                                 max_step: int = 1_000_000,
                                 final_lr: float = 1e-8) -> Callable[[int], float]:
    """Linear warmup to base_lr over `warmup` steps, then linear decay to
    final_lr at `max_step`, and final_lr after it."""
    final_rate = final_lr / base_lr

    def schedule(step: int) -> float:
        s = float(step)
        if step < warmup:
            return base_lr * (s + 1.0) / warmup
        decay = 1.0 - (1.0 - final_rate) * (s + 1.0 - warmup) / (max_step - warmup)
        return base_lr * max(decay, final_rate)

    return schedule


def get_schedule(name: str, base_lr: float, **kwargs) -> Callable[[int], float]:
    if name == "noam":
        return noam_schedule(base_lr, **kwargs)
    if name == "linear_warmup_decay":
        return linear_warmup_decay_schedule(base_lr, **kwargs)
    raise NotImplementedError(f"Unknown lr scheduler {name}")
