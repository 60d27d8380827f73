"""General CLI flags (port of ``speechclip_plus_tpu/tasks/args.py``;
reference ``avssl/util/args.py:4-38``)."""
from __future__ import annotations

import argparse

__all__ = ["add_general_arguments"]


def add_general_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--config", type=str, default=None, help="YAML config path")
    parser.add_argument("--save_path", type=str, default="exp/run", help="output dir")
    parser.add_argument("--train", action="store_true", help="train the model")
    parser.add_argument("--eval", action="store_true", help="evaluate on dev split")
    parser.add_argument("--test", action="store_true", help="evaluate on test split")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="a reference PyTorch-Lightning .ckpt to load (its config "
                             "rides inside; --config is merged over it)")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume full training state from a checkpoint directory")
    parser.add_argument(
        "--njobs", type=int, default=2,
        help="data-decode worker processes (reference DataLoader njobs); "
             "0 = single prefetch thread",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model trains on (default the GPU; "
                             "`cpu` runs the kernels' plain twins)")
    parser.add_argument("--devices", type=int, default=-1,
                        help="data-parallel ranks, one process each: -1 = every visible GPU "
                             "(one on the CPU), N = the first N; without a launcher N > 1 "
                             "spawns the ranks on this host, under torchrun or the "
                             "SPEECHCLIP_* variables it must equal the world size")
    parser.add_argument("--gpus", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=7122, help="random seed")
    parser.add_argument("--dataset_root", type=str, default=None,
                        help="override config.data.dataset.dataset_root")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser
