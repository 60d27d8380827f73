"""Train and eval steps, on one device or over a data-parallel group.

Port of ``speechclip_plus_tpu/parallel/train_step.py`` (`create_train_state`,
`make_train_step`, `make_eval_step`, `training_key`): forward in training
mode, the loss, the gradient of the trainable parameters, and an optimizer
step, with gradient accumulation over `accumulate_grad_batches` micro-steps;
the eval step's losses and retrieval features.

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

With a data-parallel `group` (``parallel/mesh.py``) each of W ranks holds
B/W rows and the step computes the loss and gradient of the global batch of
B, JAX's global-view program: the forward takes the keyword-BN and VQ
statistics over the global batch, the loss features are gathered
(`all_gather_rows`) before `compute_loss`, and the gradients are averaged over
the ranks once per optimizer step (accumulation sums locally first), so the
clip and Adam see identical gradients and the parameters stay bit-identical
(rank 0's are broadcast once, at the start). The gather's backward scales this
rank's slice by W, so that mean is the global loss's gradient for every
parameter, whether the loss reads it before the gather or after it (the
contrastive temperature; ``parallel/mesh.py`` states the convention).
Dropout and Gumbel noise are per row: rank r draws from `training_key(seed, s, device, rank=r)`, which is
today's generator on rank 0. LayerDrop is one draw for the whole batch: with
W > 1 it comes from `training_key(seed, s, device, stream="layer_drop")`, the
same on every rank; with W = 1 from the dropout generator, as without a
group, so a group of one draws bit for bit what no group draws. `grad_norm`
is then the global gradient's norm: every micro-step's without accumulation,
and with it the window's mean gradient's, logged at the window's last
micro-step (the micro-steps' own global norms would need a reduction each).

Under tensor parallelism (``parallel/tp.py``) `group` is this rank's data
column: the gradients are averaged over it alone, the generators are seeded
by the data rank (the peers of a model group draw the same masks on the
activations they both hold), and `grad_norm` and the clip take the whole
gradient's norm (`Optimizer.global_norm`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.kwclip import KWClip
from ..optim.optimizer import Optimizer
from ..utils.profiling import span
from .mesh import (DataGroup, CollectiveTimer, all_gather_rows, broadcast_module,
                   reduce_gradients)

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "training_key", "step_generators"]

_STREAMS = {"dropout": 0, "layer_drop": 1}


def training_key(seed: int, step: int, device, rank: int = 0,
                 stream: str = "dropout") -> torch.Generator:
    """The generator of micro-step `step` on `device`, seeded from (seed, step)
    alone (JAX `fold_in(key(seed), step)`): rank 0's dropout stream is the
    single-device one; another rank, or the LayerDrop stream, is a child
    sequence of the same entropy (numpy's spawn keys), independent of it."""
    entropy = [int(seed) & 0xFFFFFFFF, int(step)]
    spawn_key = () if (rank, stream) == (0, "dropout") else (_STREAMS[stream], int(rank))
    mixed = np.random.SeedSequence(entropy, spawn_key=spawn_key).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def step_generators(seed: int, step: int, device, group: Optional[DataGroup] = None
                    ) -> Tuple[torch.Generator, Optional[torch.Generator]]:
    """(dropout generator, LayerDrop generator or None) of micro-step `step`
    on this rank (the module docstring)."""
    rank = 0 if group is None else group.rank
    shared = None
    if group is not None and group.world > 1:
        shared = training_key(seed, step, device, stream="layer_drop")
    return training_key(seed, step, device, rank=rank), shared


@dataclasses.dataclass
class TrainState:
    step: int                   # micro-steps taken
    optimizer: Optimizer        # Adam, clip and the LR schedule
    grad_acc: Optional[List[torch.Tensor]] = None  # sums over an accumulation window


def create_train_state(optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, optimizer=optimizer)


def gather_rows(tree: Dict, group: Optional[DataGroup]) -> Dict:
    """`all_gather_rows` of every tensor of a dict (the loss features, an eval
    batch's outputs); other values pass through."""
    if group is None:
        return tree
    return {k: all_gather_rows(v, group) if torch.is_tensor(v) and v.ndim >= 1 else v
            for k, v in tree.items()}


def make_train_step(model: KWClip, optimizer: Optimizer, accumulate_grad_batches: int = 1,
                    group: Optional[DataGroup] = None
                    ) -> Callable[..., Dict]:
    """Returns `step_fn(state, batch, generator, layer_drop_generator=None) ->
    metrics`, which advances `state` and the model's parameters in place.
    `generator` (on the model's device) draws every dropout mask; None runs
    the step with dropout off (training statistics and scaling stay on).
    `step_generators` gives both generators of a micro-step. With `group`,
    `batch` is this rank's rows; `step_fn.timer` holds the seconds of each
    gradient all-reduce and `step_fn.reduce_bytes` its size."""
    accum = max(int(accumulate_grad_batches), 1)
    params = optimizer.params
    timer = CollectiveTimer()
    broadcast_module(model, group)

    def step_fn(state: TrainState, batch: Dict, generator: Optional[torch.Generator],
                layer_drop_generator: Optional[torch.Generator] = None):
        opt_step = state.step // accum
        with span("step.forward"):
            loss_feats, log_metrics, _ = model(batch, training=True, global_step=opt_step,
                                               generator=generator, group=group,
                                               layer_drop_generator=layer_drop_generator)
        with span("step.loss"):
            if "valid" in batch:
                loss_feats = dict(loss_feats, valid=batch["valid"])
            losses = model.compute_loss(gather_rows(loss_feats, group))
        with span("step.backward"):
            grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {f"train_{k}": v.detach() for k, v in losses.items()}
        metrics.update({f"train_{k}": torch.as_tensor(v).detach()
                        for k, v in log_metrics.items()})
        state.step += 1
        with span("step.optimizer"):
            if group is None:
                metrics["grad_norm"] = optimizer.global_norm(grads)
            if accum == 1:
                if group is not None:
                    grads = reduce_gradients(grads, group, timer)
                    metrics["grad_norm"] = optimizer.global_norm(grads)
                optimizer.apply(grads, opt_step)
                return metrics
            with torch.no_grad():
                if state.grad_acc is None:
                    state.grad_acc = [g.clone() for g in grads]
                else:
                    for a, g in zip(state.grad_acc, grads):
                        a.add_(g)
            if state.step % accum == 0:
                acc = state.grad_acc
                if group is not None:
                    acc = reduce_gradients(acc, group, timer)
                mean = [a / accum for a in acc]
                if group is not None:
                    metrics["grad_norm"] = optimizer.global_norm(mean)
                optimizer.apply(mean, opt_step)
                state.grad_acc = None
        return metrics

    step_fn.timer = timer
    step_fn.reduce_bytes = 4 * sum(p.numel() for p in params)
    return step_fn


def make_eval_step(model: KWClip, group: Optional[DataGroup] = None
                   ) -> Callable[[TrainState, Dict], Tuple[Dict, Dict]]:
    """Validation step (JAX ``:178-215``, reference `validation_step`,
    `kwClip.py:195-246`): `step_fn(state, batch) -> (metrics, out)`, without
    dropout and with keyword-BN running statistics. `metrics` are the `val_*`
    losses and log metrics as floats; `out` holds host numpy for retrieval in
    fp32: `id`, `audio_feat` (from `retrieval.audio_feat_src`), `image_feat`,
    and `keywords`, `keywords_len`, `text`, `valid` where present. With
    `group`, `batch` is this rank's rows and both are of the global batch,
    `out` in global row order on every rank."""
    src = "cascaded_audio_feat" if model.cfg.retrieval_audio_feat_src == "cascaded" \
        else "parallel_audio_feat"

    def host(t: torch.Tensor) -> np.ndarray:
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict):
        loss_feats, log_metrics, others = model(batch, training=False, global_step=state.step,
                                                group=group)
        if "valid" in batch:
            loss_feats = dict(loss_feats, valid=batch["valid"])
        losses = model.compute_loss(gather_rows(loss_feats, group))
        out = {"id": batch["id"], "audio_feat": others[src], "image_feat": others["image_feat"]}
        for key in ("keywords", "keywords_len"):
            if others.get(key) is not None:
                out[key] = others[key]
        for key in ("text", "valid"):
            if key in batch:
                out[key] = batch[key]
        out = gather_rows(out, group)
        metrics = {f"val_{k}": v for k, v in losses.items()}
        metrics.update({f"val_{k}": torch.as_tensor(v) for k, v in log_metrics.items()})
        names = list(metrics)
        values = torch.stack([metrics[k].float().reshape(()).to(batch["id"].device)
                              for k in names]).cpu().tolist()
        return dict(zip(names, values)), {k: host(v) for k, v in out.items()}

    return step_fn
