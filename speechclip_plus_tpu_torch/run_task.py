"""CLI dispatcher of the port (the root ``run_task.py`` of the JAX package;
reference ``run_task.py:11-22``):

    python -m speechclip_plus_tpu_torch.run_task TrainKWClip_GeneralTransformer \
        --config <yaml> --train [--device cpu]
"""
import argparse
import sys

from . import tasks

__all__ = ["main"]


def main(argv=None, config=None):
    """Parse `argv` (default `sys.argv[1:]`), run the named task, return its
    trainer. `config`, a loaded `ConfigNode`, takes the place of `--config`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("task", type=str, help="task class name")
    args, _ = parser.parse_known_args(argv)

    runner = getattr(tasks, args.task)()
    task_parser = argparse.ArgumentParser()
    task_parser.add_argument("task", type=str)
    runner.add_args(task_parser)
    runner.parse_args(task_parser, argv)
    return runner.run(config)


if __name__ == "__main__":
    main()
    sys.exit(0)
