"""Train and eval steps, single device.

Port of ``speechclip_plus_tpu/parallel/train_step.py`` (`create_train_state`,
`make_train_step`, `make_eval_step`, `training_key`) for one GPU: forward in
training mode, the loss, the gradient of the trainable parameters, and an
optimizer step, with gradient accumulation over `accumulate_grad_batches`
micro-steps; the eval step's losses and retrieval features.

The dropout masks of micro-step s come from `training_key(seed, s, device)`,
a generator seeded from (seed, s) alone, as JAX folds the step into the key
(``:130``): a run resumed at step s draws the masks an unbroken run draws.

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
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.kwclip import KWClip
from ..optim.optimizer import Optimizer, global_norm

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "training_key"]


def training_key(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of micro-step `step` on `device`, seeded from
    (seed, step) alone (JAX `fold_in(key(seed), step)`)."""
    mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


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


def make_eval_step(model: KWClip) -> Callable[[TrainState, Dict], Tuple[Dict, Dict]]:
    """Validation step (JAX ``:178-215``, reference `validation_step`,
    `kwClip.py:195-246`): `step_fn(state, batch) -> (metrics, out)`, without
    dropout and with keyword-BN running statistics. `metrics` are the `val_*`
    losses and log metrics as floats; `out` holds host numpy for retrieval in
    fp32: `id`, `audio_feat` (from `retrieval.audio_feat_src`), `image_feat`,
    and `keywords`, `keywords_len`, `text`, `valid` where present."""
    src = "cascaded_audio_feat" if model.cfg.retrieval_audio_feat_src == "cascaded" \
        else "parallel_audio_feat"

    def host(t: torch.Tensor) -> np.ndarray:
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict):
        loss_feats, log_metrics, others = model(batch, training=False, global_step=state.step)
        if "valid" in batch:
            loss_feats = dict(loss_feats, valid=batch["valid"])
        losses = model.compute_loss(loss_feats)
        out = {"id": batch["id"], "audio_feat": others[src], "image_feat": others["image_feat"]}
        for key in ("keywords", "keywords_len"):
            if others.get(key) is not None:
                out[key] = others[key]
        for key in ("text", "valid"):
            if key in batch:
                out[key] = batch[key]
        metrics = {f"val_{k}": v for k, v in losses.items()}
        metrics.update({f"val_{k}": torch.as_tensor(v) for k, v in log_metrics.items()})
        names = list(metrics)
        values = torch.stack([metrics[k].float().reshape(()).to(batch["id"].device)
                              for k in names]).cpu().tolist()
        return dict(zip(names, values)), {k: host(v) for k, v in out.items()}

    return step_fn
