"""Task runner: arg parsing -> datasets -> trainer -> fit/validate.

Port of ``speechclip_plus_tpu/tasks/base_task.py`` (reference
``avssl/task/base_task.py:17-215``): seed everything, build the model from a
YAML config (+ `--dataset_root`) on `--device` (the GPU unless the caller
asks for the CPU), construct split datasets + loaders, two metric-monitored
checkpoints, logger, then fit and/or validate. The frozen image tower's
features are cached once by default (`data.cache_image_embeddings`), as in
the JAX task.

`--devices` follows JAX: -1 is every visible GPU (one on the CPU), N the
first N. Data parallelism runs one process per device: under a process group
(torchrun, or the SPEECHCLIP_* variables, ``parallel/multihost.py``) the
task runs on `cuda:LOCAL_RANK` (gloo ranks on the CPU with `--device cpu`)
and `--devices` must equal the world size; without one, N > 1 spawns N ranks
on this host (`torch.multiprocessing`, a free local port), each running the
task, and `run` returns None. One device and no process group is the
single-process path. `trainer.tensor_parallel` must divide the ranks, as in
JAX (``tasks/trainer.py:71-76``); the Trainer lays them out on the 2-D grid.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ConfigNode, load_config
from ..data import BucketedLoader, CoCoDataset, FlickrDataset
from ..parallel.multihost import local_device, maybe_initialize_distributed
from ..utils.log import set_logging, set_metrics_logger
from .args import add_general_arguments
from .builder import build_model_from_config
from .trainer import Trainer

logger = logging.getLogger(__name__)

__all__ = ["BaseTask", "TrainSpeechClipBaseTask", "seed_everything"]


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class BaseTask:
    def __init__(self):
        self.args = None
        self.config = None

    def add_args(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return add_general_arguments(parser)

    def parse_args(self, parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
        self.args = parser.parse_args(argv)
        return self.args

    def run(self):
        raise NotImplementedError


def _build_dataset(cfg: ConfigNode, split: str, tokenizer=None, image_size: int = 224):
    d = cfg.data.dataset
    common = dict(
        dataset_root=d.dataset_root,
        split=split,
        load_audio=bool(getattr(d, "load_audio", True)),
        load_image=bool(getattr(d, "load_image", True)),
        tokenize_text=bool(getattr(d, "tokenizeText", False)),
        normalize_waveform=bool(getattr(d, "normalize_waveform", False)),
        tokenizer=tokenizer,
        image_size=image_size,
    )
    if d.name == "flickr":
        return FlickrDataset(
            text_file=getattr(d, "text_file", "Flickr8k.token.txt"),
            wav_rm_silence=bool(getattr(d, "wav_rm_silence", False)),
            **common,
        )
    if d.name == "coco":
        return CoCoDataset(split_prefix=getattr(d, "split_prefix", "SpokenCOCO"), **common)
    raise NotImplementedError(d.name)


def requested_ranks(devices: Optional[int], device: str) -> int:
    """The data-parallel ranks `--devices` asks for on `device`: on the GPU
    at most the visible ones; on the CPU any number of gloo ranks."""
    if torch.device(device).type != "cuda":
        return 1 if devices is None or devices < 0 else max(int(devices), 1)
    visible = torch.cuda.device_count()
    if devices is None or devices < 0:
        return max(visible, 1)
    if devices > max(visible, 1):
        raise ValueError(f"--devices {devices}: {visible} GPU(s) visible")
    return max(int(devices), 1)


def check_tensor_parallel(cfg, ranks: int) -> None:
    """Raise unless the config's `trainer.tensor_parallel` divides `ranks`
    (no config: nothing to check)."""
    trainer = getattr(cfg, "trainer", None) if cfg is not None else None
    tp = int(getattr(trainer, "tensor_parallel", 1) or 1)
    if tp <= 0 or ranks % tp:
        raise ValueError(f"trainer.tensor_parallel={tp} must divide --devices {ranks}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, task_cls, args, config, world: int, port: int) -> None:
    """One rank `run` spawned: the environment torchrun would give it, the
    process group, the task, and the group's shutdown."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_initialize_distributed(device=args.device)
    try:
        task = task_cls()
        task.args = args
        task.run(config)
    finally:
        dist.destroy_process_group()


class TrainSpeechClipBaseTask(BaseTask):
    """Reference `TrainSpeechClipBaseTask.run` (`base_task.py:55-215`);
    the image cache's seconds join `Trainer.timings["image_cache_s"]`."""

    def run(self, config: Optional[ConfigNode] = None):
        """`config`, when given, is used in place of loading `--config`."""
        args = self.args
        set_logging(args.log_level)
        seed_everything(args.seed)
        device, rank = args.device, 0
        if dist.is_initialized():
            world = dist.get_world_size()
            if args.devices is not None and args.devices > 0 and args.devices != world:
                raise ValueError(f"--devices {args.devices} under a process group of {world}")
            device, rank = local_device(), dist.get_rank()
            if rank:
                set_logging("WARNING")  # only rank 0 logs
        else:
            n = requested_ranks(args.devices, args.device)
            check_tensor_parallel(config if config is not None or not args.config
                                  else load_config(args.config), n)
            if n > 1:
                import torch.multiprocessing as mp

                mp.start_processes(_spawned_rank, args=(type(self), args, config, n, free_port()),
                                   nprocs=n, join=True, start_method="spawn")
                return None
        lightning_sd = None
        if args.ckpt and not args.ckpt.endswith(".ckpt"):
            raise NotImplementedError(
                f"--ckpt {args.ckpt}: only a reference Lightning .ckpt loads through --ckpt; "
                "a directory the Trainer saved resumes with --resume or loads with "
                "api.load_from_checkpoint")
        if args.ckpt:
            # a reference Lightning checkpoint: its config rides inside, and
            # --config (or `config`) is merged over it
            from ..checkpoint import load_lightning_checkpoint

            lightning_sd, ckpt_cfg, _ = load_lightning_checkpoint(args.ckpt)
            if config is None and args.config:
                config = load_config(args.config)
            if config is not None:
                ckpt_cfg.deep_update(config)
            config = ckpt_cfg
        if config is None:
            assert args.config, "--config required without a Lightning --ckpt"
            config = load_config(args.config)
        cfg = config
        if args.dataset_root:
            cfg.data.dataset.dataset_root = args.dataset_root
        self.config = cfg

        tokenizer = None
        bpe_path = getattr(cfg.data.dataset, "bpe_path", None)
        if bpe_path and os.path.exists(bpe_path):
            from ..data.tokenizer import SimpleTokenizer

            tokenizer = SimpleTokenizer(bpe_path)

        model, model_cfg, vocab = build_model_from_config(cfg, device=device, seed=args.seed)
        if lightning_sd is not None:
            from ..checkpoint import lightning_to_kwclip

            lightning_to_kwclip(lightning_sd, model)
            logger.info("Loaded Lightning checkpoint %s", args.ckpt)

        decoder = None
        text_processor = None
        if tokenizer is not None:
            from ..data.tokenizer import ClipTextProcessor
            from ..utils.keyword_extraction import KeywordDecoder

            decoder = KeywordDecoder(
                tokenizer.decoder, vocab.reduced2original if vocab is not None else None)
            text_processor = ClipTextProcessor(tokenizer, vocab)
        elif vocab is not None:
            # no BPE vocabulary on disk (data.dataset.bpe_path: null): the
            # keyword neighbor artifacts name tokens symbolically,
            # `tok_<original CLIP id>`, as the JAX task does
            from ..utils.keyword_extraction import KeywordDecoder

            r2o = vocab.reduced2original  # dict: reduced id -> original id
            decoder = KeywordDecoder({int(i): f"tok_{int(i)}" for i in r2o.values()}, r2o)

        save_path = args.save_path
        metrics_logger = set_metrics_logger(save_path, getattr(cfg, "logger", None),
                                            config=cfg.to_dict(), rank=rank)
        trainer = Trainer(model, cfg, save_path, seed=args.seed,
                          metrics_logger=metrics_logger, tokenizer_decoder=decoder,
                          text_processor=text_processor)
        self.trainer = trainer
        if args.resume:
            trainer.resume(args.resume)

        batch_size = int(cfg.data.batch_size)
        dev_batch_size = int(getattr(cfg.data, "dev_batch_size", batch_size))
        max_audio_len = int(getattr(cfg.audio_encoder, "max_audio_len", -1))

        # a frozen image tower's outputs are training-invariant: the cache
        # (computed once, no ViT or JPEG decode in any step) defaults on,
        # data.cache_image_embeddings: false opts out, and a trainable ViT
        # never reads it (JAX :167-170)
        cache_images = bool(getattr(cfg.data, "cache_image_embeddings", True)) \
            and not model_cfg.image_encoder_trainable

        def _maybe_cache(ds):
            if not cache_images:
                return ds
            from ..data.image_cache import CachedImageDataset, precompute_image_embeddings

            t0 = time.perf_counter()
            feats = precompute_image_embeddings(trainer.model, ds)
            trainer.timings["image_cache_s"].append(time.perf_counter() - t0)
            return CachedImageDataset(ds, feats)

        image_size = model_cfg.clip.image_resolution
        if args.train:
            train_set = _maybe_cache(_build_dataset(cfg, "train", tokenizer, image_size))
            dev_set = _maybe_cache(_build_dataset(
                cfg, "dev" if cfg.data.dataset.name == "flickr" else "val", tokenizer,
                image_size))
            # njobs = decode worker processes, as in the reference DataLoader
            # (`base_task.py:137-169`); 0 keeps a single prefetch thread
            train_loader = BucketedLoader(
                train_set, batch_size, shuffle=True, drop_last=True,
                max_audio_len=max_audio_len, train=True, seed=args.seed,
                num_workers=args.njobs, prefetch=max(2 * args.njobs, 2))
            dev_loader = BucketedLoader(
                dev_set, dev_batch_size, shuffle=False, drop_last=False,
                num_workers=args.njobs, prefetch=max(2 * args.njobs, 2))
            try:
                trainer.fit(train_loader, dev_loader)
            finally:
                train_loader.close()
                dev_loader.close()
        elif args.eval or args.test:
            split = "test" if args.test else (
                "dev" if cfg.data.dataset.name == "flickr" else "val")
            eval_set = _maybe_cache(_build_dataset(cfg, split, tokenizer, image_size))
            eval_loader = BucketedLoader(
                eval_set, dev_batch_size, shuffle=False, drop_last=False,
                num_workers=args.njobs, prefetch=max(2 * args.njobs, 2))
            try:
                metrics = trainer.validate(eval_loader)
            finally:
                eval_loader.close()
            if rank == 0:
                print({k: round(v, 4) for k, v in metrics.items()})
        return trainer
