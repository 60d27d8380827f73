"""Train step, single device.

Port of ``speechclip_plus_tpu/parallel/train_step.py`` (`create_train_state`,
`make_train_step`) for one GPU: forward in training mode, the loss, the
gradient of the trainable parameters, and an optimizer step, with gradient
accumulation over `accumulate_grad_batches` micro-steps.

`state.step` counts micro-steps (one per call); every schedule clock — the LR
schedule and CIF's `scaling_step` — advances per optimizer step,
`state.step // accumulate_grad_batches`, as Lightning's `global_step` (JAX
``:113-118``). Accumulated gradients are averaged (optax.MultiSteps), and
the clip applies to the average. Keyword-BN running statistics move on every
micro-step. Metrics stay on the device (no host sync): `train_*` losses and
log metrics, and `grad_norm`, the global norm of the micro-step's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..models.kwclip import KWClip
from ..optim.optimizer import Optimizer, global_norm

__all__ = ["TrainState", "create_train_state", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    step: int                   # micro-steps taken
    optimizer: Optimizer        # Adam, clip and the LR schedule
    grad_acc: Optional[List[torch.Tensor]] = None  # sums over an accumulation window


def create_train_state(optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, optimizer=optimizer)


def make_train_step(model: KWClip, optimizer: Optimizer, accumulate_grad_batches: int = 1
                    ) -> Callable[[TrainState, Dict, Optional[torch.Generator]], Dict]:
    """Returns `step_fn(state, batch, generator) -> metrics`, which advances
    `state` and the model's parameters in place. `generator` (on the model's
    device) draws every dropout mask; None runs the step with dropout off
    (training statistics and scaling stay on)."""
    accum = max(int(accumulate_grad_batches), 1)
    params = optimizer.params

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator]):
        opt_step = state.step // accum
        loss_feats, log_metrics, _ = model(batch, training=True, global_step=opt_step,
                                           generator=generator)
        if "valid" in batch:
            loss_feats = dict(loss_feats, valid=batch["valid"])
        losses = model.compute_loss(loss_feats)
        grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {f"train_{k}": v.detach() for k, v in losses.items()}
        metrics.update({f"train_{k}": torch.as_tensor(v).detach()
                        for k, v in log_metrics.items()})
        metrics["grad_norm"] = global_norm(grads)
        state.step += 1
        if accum == 1:
            optimizer.apply(grads, opt_step)
            return metrics
        with torch.no_grad():
            if state.grad_acc is None:
                state.grad_acc = [g.clone() for g in grads]
            else:
                for a, g in zip(state.grad_acc, grads):
                    a.add_(g)
        if state.step % accum == 0:
            optimizer.apply([a / accum for a in state.grad_acc], opt_step)
            state.grad_acc = None
        return metrics

    return step_fn
