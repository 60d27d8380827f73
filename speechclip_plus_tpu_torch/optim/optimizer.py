"""Optimizer and schedule wiring.

Port of ``speechclip_plus_tpu/optim/optimizer.py`` (reference
``avssl/model/kwClip.py:646-674``): one Adam (or AdamW) over the trainable
parameters only, with the trainer's global-norm clip and the LR schedule stepped per
optimizer step. The trainable set is JAX's (`trainable_mask`,
`audio_subset_mask`, ``:43-130``), which `KWClip` applies as `requires_grad`:
the branches, projections and temperatures; the acoustic tower when it
trains, and under `unfreeze_layers` / `reinit_layers` only the selected
layers and, for a post-norm tower, `encoder_layer_norm`; the ViT, and the
text tower with the token table and `logit_scale`, when each trains. JAX
multiplies the gradients by its subset mask before the clip and weight decay
and the updates after; leaving the other tensors out of Adam gives the same
update and the same clip norm. JAX's optax chain is
clip_by_global_norm -> add_decayed_weights (torch Adam's coupled L2) ->
scale_by_adam -> lr schedule; here:

  - `torch.optim.Adam` (β 0.9/0.999, eps 1e-8) with `weight_decay` as its
    coupled L2, which adds wd·p to the gradient before the moments; or, for
    `adamw`, `torch.optim.AdamW`, whose decay acts after the moments and is
    scaled by the scheduled learning rate, p ← p − lr (m̂/(√v̂+ε) + wd·p), as
    JAX's scale_by_adam -> add_decayed_weights -> lr schedule (``:151-157``);
  - the clip uses optax's formula g·min(1, c/‖g‖) over the trainable
    gradients, not torch's `clip_grad_norm_` (c/(‖g‖+1e-6));
  - the learning rate is set from the schedule before each Adam step, at the
    optimizer step count (optax's `scale_by_learning_rate` count).

Gradient accumulation (optax.MultiSteps in JAX) is counted by the train step
(``parallel/train_step.py``). Under tensor parallelism (``parallel/tp.py``)
the optimizer holds this rank's shards, its moments are shard-local, and
the clip's norm is the whole gradient's: each sharded tensor's squares
summed over the model group, each replicated tensor's counted once.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops.schedulers import get_schedule

__all__ = ["Optimizer", "trainable_mask", "audio_subset_mask", "trainable_parameters",
           "global_norm", "build_optimizer", "build_optimizer_from_config"]


def audio_subset_mask(name: str, cfg) -> Optional[bool]:
    """Whether the acoustic tower's parameter `name` (relative to the tower)
    trains under a subset policy (`reinit_layers` / `unfreeze_layers`, JAX
    ``:74-114``): the selected layers and, for a post-norm tower, the
    encoder LayerNorm. None when no subset policy is active."""
    sel = set(cfg.reinit_layers) or set(cfg.unfreeze_layers)
    if not (cfg.audio_trainable and sel):
        return None
    parts = name.split(".")
    if parts[0] == "layers":
        return int(parts[1]) in sel
    return parts[0] == "encoder_layer_norm" and not cfg.audio.layer_norm_first


def trainable_mask(model: nn.Module, cfg) -> Dict[str, bool]:
    """Parameter name -> whether it trains (JAX ``:43-71``): the acoustic
    tower when `audio_trainable` (within its subset policy), the ViT
    (`clip.visual`) when `image_encoder_trainable`, the rest of `clip` (the
    text tower, the token table, `logit_scale`) when
    `text_encoder_trainable`, and everything outside the towers."""
    out = {}
    for name, _ in model.named_parameters():
        root, _, rest = name.partition(".")
        if root == "audio_encoder":
            subset = audio_subset_mask(rest, cfg)
            out[name] = cfg.audio_trainable if subset is None else subset
        elif root == "clip":
            out[name] = (cfg.image_encoder_trainable if rest.startswith("visual.")
                         else cfg.text_encoder_trainable)
        else:
            out[name] = True
    return out


def trainable_parameters(model: nn.Module):
    """(name, parameter) pairs that take gradients (`requires_grad`, set from
    `trainable_mask`)."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class Optimizer:
    """Adam with coupled L2 (or AdamW's decoupled decay, `decoupled=True`)
    over `params`, global-norm clip and an LR schedule. `apply(grads, step)`
    takes the (mean) gradient of one optimizer step, aligned with `params`."""

    def __init__(self, params: Sequence[nn.Parameter], *, lr: float, weight_decay: float,
                 schedule: Callable[[int], float], gradient_clip_val: float = 0.0,
                 decoupled: bool = False):
        self.params: List[nn.Parameter] = list(params)
        self.schedule = schedule
        self.gradient_clip_val = float(gradient_clip_val or 0.0)
        adam = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.adam = adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        # tensor parallelism: the model group and which of `params` are shards
        self.model_group, self.sharded = None, None

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient aligned with `params` (of the whole
        model under tensor parallelism)."""
        if self.model_group is None:
            return global_norm(grads)
        from ..parallel.tp import sharded_global_norm

        return sharded_global_norm(grads, self.sharded, self.model_group)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], step: int) -> None:
        if self.gradient_clip_val > 0:
            # optax clip_by_global_norm: g * min(1, c / |g|), on the device
            scale = torch.clamp(self.gradient_clip_val / self.global_norm(grads), max=1.0)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(step)
        self.adam.step()
        for p in self.params:
            p.grad = None


def build_optimizer(model: nn.Module, *, optim_name: str = "Adam", lr: float = 1e-4,
                    weight_decay: float = 1e-6, scheduler_name: str = "linear_warmup_decay",
                    scheduler_args: Optional[dict] = None,
                    gradient_clip_val: float = 4.0) -> Optimizer:
    """Adam or AdamW over the model's trainable parameters (reference
    trainer settings)."""
    if optim_name.lower() not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {optim_name!r} (the port has Adam and AdamW)")
    schedule = get_schedule(scheduler_name, lr, **(scheduler_args or {}))
    named = trainable_parameters(model)
    opt = Optimizer([p for _, p in named], lr=lr, weight_decay=weight_decay, schedule=schedule,
                    gradient_clip_val=gradient_clip_val, decoupled=optim_name.lower() == "adamw")
    tp = getattr(model, "_tp", None)  # a model parallel/tp.py sharded
    if tp is not None:
        opt.model_group = tp.group
        opt.sharded = [tp.plan.get(n) is not None for n, _ in named]
    return opt


def build_optimizer_from_config(model: nn.Module, cfg_node) -> Optimizer:
    """From the reference YAML's `audio_encoder.optim`, `audio_encoder.scheduler`
    and `trainer.gradient_clip_val` (JAX `build_optimizer_from_config`)."""
    optim = cfg_node.audio_encoder.optim
    sched = cfg_node.audio_encoder.scheduler
    sched_d = sched.to_dict() if hasattr(sched, "to_dict") else dict(sched)
    name = sched_d.pop("name")
    args = optim.args.to_dict() if hasattr(optim.args, "to_dict") else dict(optim.args)
    return build_optimizer(
        model, optim_name=optim.name, lr=float(args.get("lr", 1e-4)),
        weight_decay=float(args.get("weight_decay", 0.0)), scheduler_name=name,
        scheduler_args={k: (int(v) if k in ("warmup", "max_step") else float(v))
                        for k, v in sched_d.items()},
        gradient_clip_val=float(getattr(cfg_node.trainer, "gradient_clip_val", 0.0) or 0.0))
