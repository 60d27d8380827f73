"""The reference's first training steps: plain autograd and a plain Adam.

Adam with coupled L2 (the decay added to the gradient before the moments),
beta (0.9, 0.999), eps 1e-8, after a clip of the global gradient norm to
`gradient_clip_val` (g * min(1, c / |g|)), at the learning rate of a linear
warm-up then linear decay, stepped per optimizer step. The trainable
tensors are every weight outside the two frozen towers (`audio_encoder.*`,
`clip.*`): the layer weights of the sum, the branch, CIF, the keyword head
and the contrastive temperature.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .model import Model
from .rng import step_generator

__all__ = ["trainable_names", "lr_at", "reference_steps"]


def trainable_names(W: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(n for n in W if not n.startswith(("audio_encoder.", "clip."))
                  and not n.endswith(("running_mean", "running_var")))


def lr_at(sched: dict, step: int) -> float:
    base, warm = float(sched["lr"]), int(sched["warmup"])
    if step < warm:
        return base * (step + 1.0) / warm
    final = float(sched["final_lr"]) / base
    decay = 1.0 - (1.0 - final) * (step + 1.0 - warm) / (int(sched["max_step"]) - warm)
    return base * max(decay, final)


def reference_steps(model: Model, batches, seed: int, optim: dict, n_steps: int = 3,
                    fault: str = None, forced=None):
    """Runs `n_steps` steps from the weights in `model.W` (updated in place).
    Returns {'loss': [per step], 'grad': {name: the clipped step-1 gradient
    with its decay term, as Adam's first moment gives it}, 'raw_grad': {name:
    step 1's unclipped gradient}, 'start': {name: the initial value}}.
    `fault` "half" plants a fault of the step for the control: the loss over
    the first half of each batch's rows, the mean taken over those.
    `forced` (one (B * K,) tensor a step) takes those keyword codes in place
    of the reference's own argmax: then 'kw_gap' is the widest gap by which a
    forced code's cosine lies below the reference's best. 'chosen' holds the
    codes each step took."""
    W = model.W
    names = trainable_names(W)
    start = {n: W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd, clip = float(optim["weight_decay"]), float(optim["gradient_clip_val"])
    out = {"loss": [], "start": start, "chosen": []}
    dev = W[names[0]].device
    for s in range(n_steps):
        batch = batches[s]
        for n in names:
            W[n] = W[n].detach().requires_grad_(True)
        gen = step_generator(seed, s, dev)
        feats = model.speech_features(batch["wav"], batch["wav_len"], train=True, gen=gen,
                                      step=s, forced=None if forced is None else forced[s])
        out["chosen"].append(model.chosen)
        if fault == "half":
            h = batch["id"].shape[0] // 2
            feats = {k: v[:h] for k, v in feats.items()}
            loss = model.loss(feats, batch["image_feat"][:h], batch["id"][:h])
        else:
            loss = model.loss(feats, batch["image_feat"], batch["id"])
        grads = torch.autograd.grad(loss, [W[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(W[n]) if g is None else g for n, g in zip(names, grads)]
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(clip / norm, max=1.0) if clip > 0 else 1.0
            lr = lr_at(optim, s)
            bc1, bc2 = 1.0 - b1 ** (s + 1), 1.0 - b2 ** (s + 1)
            for n, g in zip(names, grads):
                p = W[n].detach()
                g = g * scale + wd * p
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / bc2 ** 0.5 + eps
                W[n] = p - (lr / bc1) * m[n] / denom
            if s == 0:
                out["grad"] = {n: m[n] / (1 - b1) for n in names}
                out["raw_grad"] = dict(zip(names, (g.detach() for g in grads)))
        del feats, loss, grads
    for n in names:
        W[n] = W[n].detach()
    if forced is not None:
        out["kw_gap"] = model.kw_gap
    return out
