"""The program's kernel-launch counters, read around the window.

Each kernel wrapper of the program counts the calls that ran its CUDA
kernels; the rooflines multiply a call's operations and bytes by these
counts, per step, and check them against the calls the cell's shapes plan.
"""
from __future__ import annotations

import importlib
from typing import Dict

__all__ = ["COUNTERS", "read", "per_step"]

# name -> (module of the program, counter)
COUNTERS = {
    "k1": ("speechclip_plus_tpu_torch.nn.fused_attention_block", "LAUNCHES"),
    "k1a": ("speechclip_plus_tpu_torch.nn.fused_attention_block", "PROJECTION_LAUNCHES"),
    "k2": ("speechclip_plus_tpu_torch.nn.fused_attention_block_vjp", "LAUNCHES"),
    "k3": ("speechclip_plus_tpu_torch.ops.fused_keyword", "LAUNCHES"),
    "k3b": ("speechclip_plus_tpu_torch.ops.fused_keyword", "BWD_LAUNCHES"),
}


def read() -> Dict[str, int]:
    out = {}
    for name, (module, attr) in COUNTERS.items():
        out[name] = int(getattr(importlib.import_module(module), attr, 0))
    return out


def per_step(before: Dict[str, int], after: Dict[str, int], steps: int) -> Dict[str, float]:
    return {k: (after[k] - before[k]) / max(steps, 1) for k in after}
