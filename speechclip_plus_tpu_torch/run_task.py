"""CLI dispatcher of the port (the root ``run_task.py`` of the JAX package;
reference ``run_task.py:11-22``):

    python -m speechclip_plus_tpu_torch.run_task TrainKWClip_GeneralTransformer \
        --config <yaml> --train [--device cpu] [--devices N]
    torchrun --nproc_per_node N -m speechclip_plus_tpu_torch.run_task ...

The process group comes up first, from the environment, as the JAX root
`run_task.py:21-23` initializes `jax.distributed`
(``parallel/multihost.py``); one started here is shut down at the end.
"""
import argparse
import sys

import torch.distributed as dist

from . import tasks
from .parallel.multihost import maybe_initialize_distributed

__all__ = ["main"]


def main(argv=None, config=None):
    """Parse `argv` (default `sys.argv[1:]`), run the named task, return its
    trainer (None where it spawned its ranks). `config`, a loaded
    `ConfigNode`, takes the place of `--config`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("task", type=str, help="task class name")
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args(argv)
    started = not dist.is_initialized() and maybe_initialize_distributed(device=args.device)
    try:
        runner = getattr(tasks, args.task)()
        task_parser = argparse.ArgumentParser()
        task_parser.add_argument("task", type=str)
        runner.add_args(task_parser)
        runner.parse_args(task_parser, argv)
        return runner.run(config)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
    sys.exit(0)
