"""Training/validation loop.

Port of ``speechclip_plus_tpu/tasks/trainer.py`` (the reference's PL Trainer
usage, `avssl/task/base_task.py:137-215`, and the Lightning hooks in
`avssl/model/kwClip.py:145-482`) for one device: step-based fit loop with
grad accumulation, per-epoch validation with cross-modal retrieval (image
dedup by id, score matmul, recall@{1,5,10} both directions,
`kwClip.py:447-482`), metric-monitored checkpoints (top-1 val_loss +
save_last, top-3 val_recall_mean_10, `base_task.py:174-195`), keyword
detokenization JSON + PCA artifacts every N epochs (`kwClip.py:295-445`),
full-state resume and the preemption save at an optimizer-step boundary.

Alone, each batch array makes one `.to(device)`. Under a process group
(``parallel/multihost.py``) the JAX package's 1-D data mesh becomes a
`DataGroup` of W ranks (``parallel/mesh.py``): a `BucketedLoader` decodes
only this rank's rows of each global batch (`set_shard`), any other loader's
global batch is padded to a multiple of W with `valid=False` rows and sliced
(JAX ``:140-163``); the steps take the loss and the statistics over the
global batch; only rank 0 writes checkpoints, `fit_state.json`, metrics and
keyword artifacts, and a barrier follows; every rank reads a resume; a
preemption flag is all-reduced at each optimizer-step boundary, so every rank
stops at the same step. The generators of every micro-step are
`step_generators(seed, step, ...)`, so a resumed run repeats an unbroken one.
`trainer.tensor_parallel: tp` > 1 lays the ranks out on a (data, model) grid
of tp ranks to a model group (``parallel/tp.py``, JAX ``:66-98``): the model
is sharded Megatron-style over each model group before the optimizer is
built, the loader decodes each data rank's rows (the peers of a model group
decode the same ones), the gradients are averaged over the data group, the
checkpoints hold whole tensors written by global rank 0, and the preemption
flag and the barriers span every rank. `timings` keeps the loop's own clock: the host's wait on the loader (and the
copy to the device) per micro-step, the seconds of each pass over the
training loader (from its start to the end of its last step on the device,
so each epoch's loader restart is in it and no validation or save is), of
each validation (keyword artifacts included, and also kept apart), checkpoint
save and image-cache build (the task appends those), and under a group the
gradient all-reduce's seconds per optimizer step (`allreduce_s`).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..models.kwclip import KWClip
from ..ops.retrieval import mutual_retrieval
from ..optim.optimizer import build_optimizer_from_config
from ..parallel import tp as tensor_parallel
from ..parallel.mesh import DataGroup, any_rank, barrier, make_mesh, pad_batch, shard_batch
from ..parallel.multihost import make_global_batch
from ..parallel.train_step import (create_train_state, make_eval_step, make_train_step,
                                   step_generators)
from ..utils.keyword_extraction import KeywordDecoder, extract_keyword_neighbors
from ..utils.log import MetricsLogger
from ..utils.profiling import span
from ..utils.visualization import draw_embedding_space_pca

logger = logging.getLogger(__name__)

__all__ = ["Trainer"]


class Trainer:
    def __init__(
        self,
        model: KWClip,
        cfg_node,
        save_path: str,
        *,
        seed: int = 7122,
        metrics_logger: Optional[MetricsLogger] = None,
        tokenizer_decoder: Optional[KeywordDecoder] = None,
        text_processor=None,  # data.tokenizer.ClipTextProcessor for gold text
    ):
        self.model = model
        self.cfg = cfg_node
        self.model_cfg = model.cfg
        self.save_path = save_path
        self.seed = seed
        self.device = next(model.parameters()).device
        os.makedirs(save_path, exist_ok=True)
        tp = int(getattr(cfg_node.trainer, "tensor_parallel", 1) or 1)
        # the data group of the process group, None alone (JAX :63-81); with
        # tensor parallelism this rank's data column, and `world` every rank
        self.model_group = None
        if tp > 1:
            self.model_group = tensor_parallel.make_mesh_2d(tp, self.device)
            tensor_parallel.shard_model(model, self.model_group)
            self.group = self.model_group.data()
            self.world = DataGroup(rank=self.model_group.global_rank,
                                   world=self.group.world * tp, device=self.device)
        else:
            self.group = make_mesh(self.device)
            self.world = self.group
        self.writer = self.world is None or self.world.rank == 0

        self.optimizer = build_optimizer_from_config(model, cfg_node)
        self.accum = max(
            int(getattr(cfg_node.trainer, "accumulate_grad_batches", 1) or 1), 1)
        self.state = create_train_state(self.optimizer)
        self.train_step = make_train_step(model, self.optimizer, self.accum, group=self.group)
        self.eval_step = make_eval_step(model, group=self.group)
        self._allreduce_timer = self.train_step.timer

        trainer_cfg = cfg_node.trainer
        # max_steps counts *optimizer* steps (Lightning semantics): with
        # accumulate_grad_batches=k the fit loop runs k micro-steps per
        # optimizer step
        self.max_steps = int(getattr(trainer_cfg, "max_steps", 50000))
        self.log_every = int(getattr(trainer_cfg, "log_every_n_steps", 8))
        self.val_every_epoch = int(getattr(trainer_cfg, "check_val_every_n_epoch", 1))
        log_setting = getattr(cfg_node, "log_setting", None)
        self.log_detok = bool(getattr(log_setting, "log_detokenize_results", False))
        self.detok_every = int(
            getattr(log_setting, "log_detokenize_results_every_n_epoch", 10) or 10)
        self.pca_every = int(getattr(log_setting, "log_draw_pca_every_n_epoch", 0) or 0)
        self.recall_at = tuple(getattr(cfg_node.retrieval, "recall_at", [1, 5, 10]))
        self.metrics_logger = metrics_logger or MetricsLogger(save_path, enabled=self.writer)
        self.tokenizer_decoder = tokenizer_decoder
        self.text_processor = text_processor

        self.ckpt = CheckpointManager(
            os.path.join(save_path, "checkpoints"),
            config=cfg_node.to_dict() if hasattr(cfg_node, "to_dict") else None,
            writer=self.writer,
        )
        self.epoch = 0
        # preemption: fit() installs SIGTERM/SIGINT handlers that set this
        # flag; the loop checkpoints and returns at the next optimizer-step
        # boundary
        self._preempt_signum: Optional[int] = None
        self._stop_flag = None  # reads the flags all-reduced at the last boundary
        self._skip_batches = 0
        self.timings: Dict[str, list] = {"loader_wait_s": [], "train_s": [], "validate_s": [],
                                         "save_s": [], "artifacts_s": [], "image_cache_s": [],
                                         "allreduce_s": []}

    # ------------------------------------------------------------- fit ----

    def _shard(self, loader) -> bool:
        """Under a group, have a loader that can decode only this rank's rows
        of each global batch do so; returns whether its batches are local."""
        if self.group is None or not hasattr(loader, "set_shard"):
            return False
        loader.set_shard(self.group.rank, self.group.world)
        return True

    def _device_batch(self, batch: Dict, local: bool = False) -> Dict[str, torch.Tensor]:
        """numpy batch -> tensors on the model's device (one copy each); under
        a group a global batch (`local` False) is padded and sliced to this
        rank's rows first."""
        if self.group is not None and not local:
            batch = shard_batch(pad_batch(batch, self.group.world), self.group)
        return make_global_batch(batch, self.group, self.device)

    @property
    def _fit_state_path(self) -> str:
        return os.path.join(self.save_path, "checkpoints", "fit_state.json")

    def _save_fit_state(self, batches_done: int = 0) -> None:
        """Persist the loop state the checkpoint doesn't carry (epoch, and for
        a mid-epoch preemption save the batches already consumed this epoch),
        so resume continues the shuffle order, validation cadence and
        artifact numbering instead of replaying epoch 0. It follows every
        save; under a group rank 0 writes and the ranks meet at a barrier."""
        if self.writer:
            with open(self._fit_state_path, "w") as f:
                json.dump({"epoch": self.epoch, "opt_step": self.opt_step,
                           "batches_done": batches_done}, f)
        barrier(self.world)

    def _save(self, metrics: Optional[Dict[str, float]] = None) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(self.opt_step, self.model, self.state, metrics)
        self.timings["save_s"].append(time.perf_counter() - t0)

    def resume(self, ckpt_dir: str) -> None:
        """Restore full fit state (parameters, buffers, Adam state, step,
        epoch) from a checkpoint directory (reference `--resume`,
        `base_task.py:60-61,206,211`).

        Accepts the checkpoint manager's root (the directory holding
        fit_state.json and the last/val_loss/val_recall_mean_10 managers) or
        a manager or step directory inside it, such as `checkpoints/last`."""
        ckpt_dir = os.path.abspath(ckpt_dir)
        probe = ckpt_dir
        for _ in range(3):
            if os.path.exists(os.path.join(probe, "fit_state.json")):
                ckpt_dir = probe
                break
            probe = os.path.dirname(probe)
        CheckpointManager(ckpt_dir).restore(self.model, self.state)
        fit_state = os.path.join(ckpt_dir, "fit_state.json")
        if os.path.exists(fit_state):
            with open(fit_state) as f:
                fs = json.load(f)
            self.epoch = int(fs["epoch"])
            # mid-epoch preemption save: re-enter the epoch's shuffle stream
            # past the batches already trained (exact resume, no replay)
            self._skip_batches = int(fs.get("batches_done", 0))
        else:
            logger.warning(
                "%s has no fit_state.json; epoch restarts at 0 (shuffle "
                "order and artifact numbering will replay)", ckpt_dir)
        logger.info("Resumed from %s at step %d epoch %d",
                    ckpt_dir, int(self.state.step), self.epoch)

    @property
    def opt_step(self) -> int:
        """Optimizer steps completed (Lightning `global_step`):
        micro-steps // accumulate_grad_batches."""
        return int(self.state.step) // self.accum

    def _install_preempt_handlers(self):
        """SIGTERM/SIGINT set a flag; the fit loop checkpoints and returns at
        the next optimizer-step boundary. Returns the previous handlers
        (restored by fit's finally)."""
        import signal

        def _on_signal(signum, frame):
            self._preempt_signum = signum

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _on_signal)
            except ValueError:
                pass  # not the main thread (e.g. under a test runner)
        return prev

    def _stop_at_boundary(self) -> bool:
        """Whether to stop for a preemption at this optimizer-step boundary.
        Under a group: the max over the ranks of the flags of the previous
        boundary, all-reduced there and read here, so that reading it waits
        only for the step before last and every rank stops at the same step."""
        if self.world is None:
            return self._preempt_signum is not None
        pending = self._stop_flag
        self._stop_flag = any_rank(self._preempt_signum is not None, self.world)
        return pending is not None and pending()

    def _stop_now(self) -> bool:
        """The same, read at once (after a pass, validation and save)."""
        if self.world is None:
            return self._preempt_signum is not None
        return any_rank(self._preempt_signum is not None, self.world)()

    def _preempt_save(self, batches_done: int) -> None:
        self._save()  # the manager skips a step it holds
        self._save_fit_state(batches_done=batches_done)
        logger.warning(
            "preempted (signal %s): checkpointed at opt_step %d, epoch %d, "
            "%d batches into the epoch; --resume continues exactly here",
            self._preempt_signum, self.opt_step, self.epoch, batches_done)

    def _validate_and_save(self, val_loader: Iterable) -> None:
        t0 = time.perf_counter()
        val_metrics = self.validate(val_loader)
        self.timings["validate_s"].append(time.perf_counter() - t0)
        self._save(val_metrics)
        self._save_fit_state()

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None) -> None:
        import signal

        last_log_step = int(self.state.step)
        last_log_time = time.time()
        # after resume, continue the per-epoch shuffle stream where it left
        # off (the loader seeds each epoch's order on seed+epoch)
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(self.epoch)
        local = self._shard(train_loader)
        self._stop_flag = None
        prev_handlers = self._install_preempt_handlers()
        try:
            while self.opt_step < self.max_steps:
                epoch_complete = True
                skip = self._skip_batches
                self._skip_batches = 0
                t_pass = time.perf_counter()
                batches = iter(train_loader)
                i = -1
                while True:
                    t0 = time.perf_counter()
                    with span("fit.next_batch", step=int(self.state.step)):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    i += 1
                    if i < skip:
                        continue
                    if int(self.state.step) % self.accum == 0 and self._stop_at_boundary():
                        # optimizer-step boundary: the grad accumulator is
                        # empty, so the saved state is exact and resume can
                        # re-enter the shuffle stream at batch i
                        self._preempt_save(batches_done=i)
                        return
                    if self.opt_step >= self.max_steps:
                        # stopped mid-epoch: don't advance the epoch counter;
                        # a resume that extends max_steps replays this epoch
                        # from its start (same shuffle stream)
                        epoch_complete = False
                        break
                    micro_step = int(self.state.step)
                    with span("fit.h2d", step=micro_step):
                        dev_batch = self._device_batch(batch, local)
                    self.timings["loader_wait_s"].append(time.perf_counter() - t0)
                    with span("fit.step", step=micro_step):
                        gen, layer_drop_gen = step_generators(self.seed, micro_step,
                                                              self.device, self.group)
                        extra = () if layer_drop_gen is None else (layer_drop_gen,)
                        metrics = self.train_step(self.state, dev_batch, gen, *extra)
                    if micro_step % self.log_every == 0:
                        with span("fit.log", step=micro_step):
                            names = [k for k, v in metrics.items()
                                     if torch.as_tensor(v).ndim == 0]
                            values = torch.stack([torch.as_tensor(metrics[k]).float()
                                                  for k in names]).cpu().tolist()
                            row = dict(zip(names, values))
                            now = time.time()
                            done = int(self.state.step) - last_log_step
                            row["steps_per_sec"] = (
                                done / max(now - last_log_time, 1e-9) if done else 0.0)
                            row["micro_step"] = float(int(self.state.step))
                            last_log_step = int(self.state.step)
                            last_log_time = now
                            self.metrics_logger.log(row, self.opt_step)
                if self.device.type == "cuda":
                    with span("fit.sync"):
                        torch.cuda.synchronize(self.device)
                self.timings["train_s"].append(time.perf_counter() - t_pass)
                self.timings["allreduce_s"] += self._allreduce_timer.collect()
                if not epoch_complete:
                    break
                self.epoch += 1
                if val_loader is not None and self.epoch % self.val_every_epoch == 0:
                    self._validate_and_save(val_loader)
                    last_log_time = time.time()  # don't bill val time to steps/sec
                    last_log_step = int(self.state.step)
                if self._stop_now():
                    # arrived during validation/checkpointing: the epoch-end
                    # save above already persisted a clean boundary
                    self._preempt_save(batches_done=0)
                    return
            if val_loader is not None:
                self._validate_and_save(val_loader)
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    # ------------------------------------------------------- validation ----

    def validate(self, val_loader: Iterable) -> Dict[str, float]:
        all_out = []
        agg: Dict[str, list] = {}
        local = self._shard(val_loader)
        for batch in val_loader:
            metrics, out = self.eval_step(self.state, self._device_batch(batch, local))
            valid = out.get("valid")
            # scalar metrics are per-batch means over *valid* rows; weight
            # the cross-batch aggregate by valid count so a final padded
            # batch doesn't count like a full one (reference computes losses
            # on the full gathered val set, kwClip.py:248-285)
            n_valid = int(valid.sum()) if valid is not None else int(out["id"].shape[0])
            if valid is not None:
                out = {k: v[valid] if v.ndim >= 1 and v.shape[0] == valid.shape[0] else v
                       for k, v in out.items()}
            all_out.append(out)
            for k, v in metrics.items():
                agg.setdefault(k, []).append((float(v), n_valid))

        val_metrics = {
            k: float(sum(v * w for v, w in pairs) / max(sum(w for _, w in pairs), 1))
            for k, pairs in agg.items()
        }

        # ---- retrieval (reference kwClip.py:447-482) ----
        ids = np.concatenate([o["id"] for o in all_out])
        audio_feats = np.concatenate([o["audio_feat"] for o in all_out])
        image_feats = np.concatenate([o["image_feat"] for o in all_out])
        # dedup images by id (5 captions per image)
        uniq_ids, first_idx = np.unique(ids, return_index=True)
        gallery = image_feats[first_idx]
        scores = audio_feats.astype(np.float32) @ gallery.astype(np.float32).T
        r_ai, r_ia, r_mean = mutual_retrieval(scores, scores.T, ids, uniq_ids, self.recall_at)
        for k, v in r_ai.items():
            val_metrics[f"val_recall_AI_{k}"] = v
        for k, v in r_ia.items():
            val_metrics[f"val_recall_IA_{k}"] = v
        for k, v in r_mean.items():
            val_metrics[f"val_recall_mean_{k}"] = v
        # the checkpoint monitor metric (reference kwClip.py:595-598); when
        # retrieval.recall_at excludes 10, the largest configured k, with a
        # warning
        if "recall@10" in r_mean:
            val_metrics["val_recall_mean_10"] = r_mean["recall@10"]
        else:
            k = f"recall@{max(self.recall_at)}"
            logger.warning(
                "retrieval.recall_at=%s has no 10; using %s as the "
                "val_recall_mean_10 checkpoint monitor", self.recall_at, k)
            val_metrics["val_recall_mean_10"] = r_mean[k]
        logger.info("val: loss=%.4f recall@1/5/10 A->I %s I->A %s mean %s",
                    val_metrics.get("val_loss", float("nan")), r_ai, r_ia, r_mean)

        # ---- keyword artifacts (reference kwClip.py:295-445) ----
        has_keywords = any("keywords" in o for o in all_out)
        if has_keywords and self.log_detok and self.epoch % self.detok_every == 0:
            # the whole table: a collective over a tensor-parallel model group
            token_emb = tensor_parallel.full_parameter(
                self.model, "clip.text.token_embedding.weight")
        if (has_keywords and self.log_detok and self.epoch % self.detok_every == 0
                and self.writer):
            t0 = time.perf_counter()
            self._dump_keyword_artifacts(all_out, token_emb)
            self.timings["artifacts_s"].append(time.perf_counter() - t0)

        self.metrics_logger.log(val_metrics, self.opt_step)
        return val_metrics

    def _dump_keyword_artifacts(self, all_out, token_emb: torch.Tensor) -> None:
        os.makedirs(os.path.join(self.save_path, "retokenizeText"), exist_ok=True)
        os.makedirs(os.path.join(self.save_path, "visualization"), exist_ok=True)
        kws = np.concatenate([o["keywords"] for o in all_out if "keywords" in o])
        lens = None
        if all("keywords_len" in o for o in all_out):
            lens = np.concatenate([o["keywords_len"] for o in all_out])
        token_emb = token_emb.detach().float().cpu().numpy()
        if self.pca_every > 0 and self.epoch % self.pca_every == 0:
            draw_embedding_space_pca(
                kws, token_emb,
                os.path.join(self.save_path, "visualization", f"pca_ep{self.epoch}.pdf"))
        if self.tokenizer_decoder is not None:
            gold_texts = [""] * len(kws)
            if self.text_processor is not None and all("text" in o for o in all_out):
                # gold captions: decode the original-id token rows
                # (reference kwClip.py:379-387; text is in original-id space)
                texts = np.concatenate([o["text"] for o in all_out])
                gold_texts = [self.text_processor.tokenizer.decode(row) for row in texts]
            neighbors = extract_keyword_neighbors(
                kws, token_emb, gold_texts=gold_texts, decoder=self.tokenizer_decoder,
                K=5, keyword_lengths=lens)
            with open(os.path.join(self.save_path, "retokenizeText",
                                   f"keywords_ep{self.epoch}.json"), "w") as f:
                json.dump(neighbors, f, indent=4)
