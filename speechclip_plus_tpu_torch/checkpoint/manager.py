"""Checkpoints with metric-monitored retention.

Port of ``speechclip_plus_tpu/checkpoint/orbax_io.py`` with `torch.save` /
`torch.load` in place of orbax. Reference checkpointing
(`avssl/task/base_task.py:174-195`): top-1 on `val_loss` (+ save_last) and
top-3 on `val_recall_mean_10`; the model config rides along so a checkpoint
needs no external arguments; a fit resume restores the optimizer and the step.

Layout, as orbax lays out its managers: `<root>/config.json` and one directory
per manager, `<root>/{last,val_loss,val_recall_mean_10}/<step>/state.pt` (a
monitor's step also keeps its `metrics.json`). The state is one dict: the
model's `state_dict` (trainable fp32 masters, frozen towers, keyword-BN
buffers), the Adam state and `TrainState.step`. It is written once per save
and hard-linked into the other managers that keep the same step.

Retention follows orbax's policies: `last` keeps the latest step; a monitor
keeps its best `top_k` steps, ranked by a stable sort of the metric in step
order, so of equal values the later step wins; a save at a step no later
than the manager's latest kept step is skipped.

Under data parallelism every rank holds the same state: only rank 0 writes
(`writer=False` elsewhere makes `save` and the config a no-op), and every
rank restores. Under tensor parallelism (``parallel/tp.py``) the state holds
whole tensors, the sharded parameters and their Adam moments gathered over
each model group (every rank takes part in a save), so a checkpoint is
independent of `tensor_parallel`: each rank restores its shards of it, at
the `tp` it saved with or at another.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import tp

__all__ = ["CheckpointManager"]

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    """Save/restore the model, the train state and the config with best-k
    metric retention."""

    def __init__(self, root: str, config: Optional[dict] = None,
                 monitors: Dict[str, str] = None, top_k: Dict[str, int] = None,
                 writer: bool = True):
        """monitors: {"val_loss": "min", "val_recall_mean_10": "max"}
        (the reference's two callbacks); top_k per monitor (1 and 3); `writer`
        False: a rank that restores and never writes."""
        self.root = os.path.abspath(root)
        self.writer = writer
        if writer:
            os.makedirs(self.root, exist_ok=True)
        self.config = config
        self.monitors = monitors or {"val_loss": "min", "val_recall_mean_10": "max"}
        self.top_k = top_k or {"val_loss": 1, "val_recall_mean_10": 3}
        if config is not None and writer:
            with open(os.path.join(self.root, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def _dir(self, manager: str) -> str:
        return os.path.join(self.root, manager.replace("/", "_"))

    def steps(self, manager: str = "last") -> List[int]:
        """Steps kept by `manager` ("last" or a monitor), ascending."""
        d = self._dir(manager)
        if not os.path.isdir(d):
            return []
        return sorted(int(s) for s in os.listdir(d)
                      if s.isdigit() and os.path.exists(os.path.join(d, s, STATE_FILE)))

    def _metric(self, monitor: str, step: int) -> float:
        with open(os.path.join(self._dir(monitor), str(step), METRICS_FILE)) as f:
            return float(json.load(f)[monitor])

    def _ranked(self, monitor: str) -> List[int]:
        """The monitor's steps, worst first (orbax BestN: a stable sort in
        step order, reversed for "min")."""
        return sorted(self.steps(monitor), key=lambda s: self._metric(monitor, s),
                      reverse=self.monitors[monitor] == "min")

    def save(self, step: int, model: torch.nn.Module, state,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Save at an optimizer-step boundary (`state.grad_acc` empty)."""
        if state.grad_acc is not None:
            raise ValueError("a checkpoint is taken only between optimizer steps")
        sharded = tp.model_group_of(model) is not None
        if sharded:  # a collective over each model group: every rank gathers
            payload = {"model": tp.gather_state_dict(model),
                       "optimizer": tp.gather_optimizer_state(
                           state.optimizer.adam.state_dict(), model)}
        if not self.writer:
            return
        metrics = {
            k: float(v) for k, v in (metrics or {}).items()
            if isinstance(v, (int, float, np.floating, np.integer))
        }
        targets = [m for m in ("last", *self.monitors)
                   if (m == "last" or m in metrics)
                   and (self.latest_step(m) is None or self.latest_step(m) < step)]
        if not targets:
            return
        if not sharded:
            payload = {"model": model.state_dict(),
                       "optimizer": state.optimizer.adam.state_dict()}
        payload["step"] = int(state.step)
        first = None
        for m in targets:
            d = os.path.join(self._dir(m), str(step))
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, STATE_FILE)
            if m != "last":
                with open(os.path.join(d, METRICS_FILE), "w") as f:
                    json.dump(metrics, f)
            if first is None:
                torch.save(payload, path + ".tmp")
                os.replace(path + ".tmp", path)
                first = path
            else:
                try:
                    os.link(first, path + ".tmp")
                except OSError:
                    shutil.copyfile(first, path + ".tmp")
                os.replace(path + ".tmp", path)
        self._retain()

    def _retain(self) -> None:
        drop = [("last", s) for s in self.steps("last")[:-1]]
        for m in self.monitors:
            ranked = self._ranked(m)
            drop += [(m, s) for s in ranked[:max(len(ranked) - self.top_k.get(m, 1), 0)]]
        for m, s in drop:
            shutil.rmtree(os.path.join(self._dir(m), str(s)))

    def best_step(self, monitor: str) -> Optional[int]:
        ranked = self._ranked(monitor)
        return ranked[-1] if ranked else None

    def latest_step(self, manager: str = "last") -> Optional[int]:
        steps = self.steps(manager)
        return steps[-1] if steps else None

    def restore(self, model: torch.nn.Module, state=None, step: Optional[int] = None,
                monitor: Optional[str] = None) -> int:
        """Load a checkpoint into `model` and `state` in place (`state` None:
        the model alone, for inference); returns its step. `monitor` picks the
        best step under that metric; default the latest."""
        manager = monitor or "last"
        if step is None:
            step = self.best_step(monitor) if monitor else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found under {self.root}")
        payload = torch.load(os.path.join(self._dir(manager), str(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        tp.load_full_state_dict(model, payload["model"])
        if state is None:
            return step
        state.optimizer.adam.load_state_dict(tp.shard_optimizer_state(payload["optimizer"], model))
        state.step = int(payload["step"])
        state.grad_acc = None
        return step

    @staticmethod
    def load_config(root: str) -> dict:
        with open(os.path.join(os.path.abspath(root), "config.json")) as f:
            return json.load(f)