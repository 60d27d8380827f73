"""Readings that set the limits of `correct`, at a cell's own size.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] [--program [--free]]

Without `--program`, for each seed: the control (the float32 reference put
in the program's place and computed with every product's operands rounded
to float8 e4m3, the precision below the configurations' bf16, judged on its
own keyword codes as the program is) and the planted faults a cell can
have, each read against the float32 reference by the numbers of
``lib/check.py`` (the loop's `control`). With `--program`: the program's own
readings, as a run's check takes them, for each seed in one process (a
training cell's set-up steps, a serving cell's short window); `--free` adds
the reading of a reference that chooses its own keyword codes. One JSON
line per seed and kind.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--free", action="store_true")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.lib.cell import Run, no_tf32
    from port_bench.lib.check import worst_leaves
    from port_bench.run import load_loop, resolve_cell

    _, cell, cfg, mix, limits = resolve_cell(ROOT, args.workload)
    loop = load_loop(ROOT, mix["loop"])
    for seed in args.seeds:
        def say(line, seed=seed):
            print(json.dumps({"seed": seed, **line}), flush=True)

        # a serving cell's answers come from its window: a short one
        run = Run(cfg, mix, seed, 0.0 if mix["loop"] == "train" else 4.0, args.device)
        if args.program:
            run.build()
            loop.drive(run)
            with no_tf32():
                for kind, free in (("program", False),) + ((("program_free", True),)
                                                            if args.free else ()):
                    line = {"kind": kind, **loop.check(run, free=free)}
                    if getattr(run, "ref", None) is not None and "grad" in run.ref:
                        line["worst"] = worst_leaves(run.prog, run.ref)
                    say(line)
        else:
            run.build(meta=True)
            with no_tf32():
                loop.control(run, say)
        del run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(json.dumps({"limits": limits}), flush=True)


if __name__ == "__main__":
    main()
