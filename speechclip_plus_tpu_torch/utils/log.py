"""Logging setup and experiment-metric logging.

Port of ``speechclip_plus_tpu/utils/log.py``.

Reference: ``avssl/util/log.py`` — stdlib logging config from `--log_level`
(:10-22) and a PL-logger factory returning W&B or bool (:25-55); scalar
metrics are logged through Lightning's `log_dict` with `sync_dist=True`
(`kwClip.py:171-188`).

Here: the same stdlib setup, plus a dependency-free `MetricsLogger` that
writes JSONL (always) and mirrors to W&B / TensorBoard when those packages
exist. The loss is taken on the whole batch (under data parallelism every
rank computes the same global loss), so there is no separate sync step, and
only rank 0 writes (`enabled=False` elsewhere).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

__all__ = ["set_logging", "MetricsLogger", "set_metrics_logger"]


def set_logging(level: str = "INFO") -> None:
    """Configure stdlib logging (reference `log.py:10-22`)."""
    logging.basicConfig(
        level=getattr(logging, str(level).upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )


class MetricsLogger:
    """JSONL metrics sink with optional W&B / TensorBoard mirrors.

    Replaces the reference's `set_pl_logger` (`log.py:25-55`): `logger:
    wandb` mirrors to Weights & Biases when installed; `logger: tensorboard`
    to TB when installed; the JSONL file is always written so runs are
    inspectable without either.
    """

    def __init__(
        self,
        save_dir: str,
        backend: Optional[str] = None,
        project: Optional[str] = None,
        run_name: Optional[str] = None,
        config: Optional[dict] = None,
        enabled: bool = True,
    ):
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._fh = None
        self._wandb = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(save_dir, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        if backend == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project or "speechclip_plus_tpu_torch",
                    name=run_name or os.path.basename(os.path.normpath(save_dir)),
                    config=config,
                    dir=save_dir,
                )
            except Exception:  # pragma: no cover - wandb absent/offline
                logging.getLogger(__name__).warning(
                    "wandb unavailable; metrics go to %s only", self.path
                )
        elif backend in ("tensorboard", "tb", True):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=save_dir)
            except Exception:  # pragma: no cover
                logging.getLogger(__name__).warning(
                    "tensorboard unavailable; metrics go to %s only", self.path
                )

    def log(self, metrics: Dict, step: int) -> None:
        if self._fh is None:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._fh.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row, step=int(step))
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, float) and k not in ("time",):
                    self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


def set_metrics_logger(save_dir: str, logger_cfg, config: Optional[dict] = None,
                       rank: int = 0) -> MetricsLogger:
    """Build from the reference config schema (`trainer.logger` +
    `logger.project`); a silent logger on a rank other than 0."""
    backend = None
    project = None
    if logger_cfg is not None:
        backend = getattr(logger_cfg, "backend", None) or getattr(
            logger_cfg, "name", None
        )
        project = getattr(logger_cfg, "project", None)
    return MetricsLogger(save_dir, backend=backend, project=project, config=config,
                         enabled=rank == 0)
