"""Seeded weights, made on the device in one draw, in each tensor's own type.

The benchmark makes the weights; the program under test and the reference
both get the same values. One standard-normal draw of every element at once
on the device's generator, cut into the tensors in name order and scaled by
the usual rule: fan-in normal for weights (1 / sqrt(fan_in)), zeros for
biases and the layer weights of the sum, ones for norm scales, CLIP's
standard deviations for its embeddings, and a unit normal for the branch's
CLS rows. Each value is rounded once to the type the program stores it in.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["Spec", "spec_of", "make_weights"]

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]

_STD = (("cls", 1.0), ("class_embedding", 0.02), ("visual.positional_embedding", 0.02),
        ("text.positional_embedding", 0.01), ("token_embedding.weight", 0.02))
_ZERO = ("weightedsum", "clip.logit_scale")
_KEEP = ("criterion_log_inv_temp",)  # the model's own log(1 / T)


def spec_of(module: torch.nn.Module) -> Spec:
    """(name, shape, dtype) of every parameter, in name order."""
    return sorted((n, tuple(p.shape), p.dtype) for n, p in module.named_parameters())


def _is_norm_scale(name: str) -> bool:
    parts = name.split(".")
    if parts[-1] != "weight" or len(parts) < 2:
        return False
    owner = parts[-2] if not parts[-2].isdigit() else parts[-3]
    return "norm" in owner.lower() or owner.startswith("ln_") or owner in ("gn", "bn_layer")


def _std(name: str, shape) -> float:
    for key, std in _STD:
        if name.endswith(key):
            return std
    if name.split(".")[-1] in ("proj", "text_projection") and len(shape) == 2:
        return shape[0] ** -0.5
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    return 1.0 / math.sqrt(max(1, fan_in))


@torch.no_grad()
def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor on `device` in the spec's dtype, from `seed` alone."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for _, s, _ in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, dtype in spec:
        n = math.prod(shape)
        chunk = flat[at: at + n].view(shape)
        at += n
        if name.endswith(_KEEP):
            continue
        if _is_norm_scale(name):
            value = torch.ones(shape, device=device)
        elif name.split(".")[-1] == "bias" or name.endswith(_ZERO) or name.endswith("bias"):
            value = torch.zeros(shape, device=device)
        else:
            value = chunk * _std(name, shape)
        out[name] = value.to(dtype)
    del flat
    return out
