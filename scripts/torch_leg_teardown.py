"""Path Q's group-less leg again and again, each exiting through the
interpreter's normal teardown (PyTorch/CUDA port, on the card).

Each leg is path Q1's group-less leg (`chip_smoke.fit_leg`, or `dp_leg` in
a checkout from before it: `run_task --train` on the synthetic tree, 8
steps, the prefetch thread) in a process of its own, under Python's fault
handler and a `std::terminate` handler (`scripts/terminate_probe.cpp`, built
with g++) that names the aborting thread and prints its native stack. One
line per leg: the exit code, whether the result was written, the seconds,
and the Python threads still alive when `run_task` returned (or the end of
stderr where the leg failed). `--root` takes `chip_smoke.py` and the port
from another checkout (an unpacked parent commit, say):

    python3 scripts/torch_leg_teardown.py --legs 28 --parallel 2 [--root .parent]

The first leg runs alone (it builds the kernels); the rest `--parallel` at
a time. Needs a CUDA card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def leg(root, probe, spec):
    ctypes.CDLL(probe).install()
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    try:
        if hasattr(chip_smoke, "fit_leg"):
            chip_smoke.fit_leg(0, {"label": "leg", "tree": spec["tree"], "world": 1,
                                   "group": None, "runs": [{
                                       "name": "leg", "save": spec["save"], "out": spec["out"],
                                       "argv": [], "cfg": {"trainer.max_steps": spec["max_steps"],
                                                           "trainer.log_every_n_steps": 2}}]})
        else:
            chip_smoke.dp_leg(spec)
    except chip_smoke.SmokeFailure as e:  # the leg's own check of the threads left
        print(f"leg check: {e}", file=sys.stderr)
    alive = [t.name for t in threading.enumerate() if t is not threading.main_thread()]
    print(f"threads alive after run_task: {alive}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", type=int, default=28)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.leg:
        leg(root, *json.loads(args.leg))
        return 0
    tmp = tempfile.mkdtemp()
    probe = os.path.join(tmp, "terminate_probe.so")
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", probe,
                    os.path.join(HERE, "terminate_probe.cpp")], check=True)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    tree = os.path.join(tmp, "flickr")
    print(chip_smoke.make_synthetic_tree(tree, chip_smoke.FIT_TREE), flush=True)

    def run(i):
        spec = {"tree": tree, "save": os.path.join(tmp, f"leg{i}"), "max_steps": 8, "argv": [],
                "out": os.path.join(tmp, f"leg{i}.json")}
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
                              "--root", root, "--leg", json.dumps([probe, spec])],
                             capture_output=True, text=True, env=chip_smoke.bare_env(),
                             timeout=600)
        tail = out.stderr.strip().splitlines()[-1:] if out.returncode == 0 else out.stderr[-8000:]
        written = any(os.path.exists(spec["out"] + end) for end in ("", ".0.json"))
        return (f"leg {i}: exit {out.returncode}, result "
                f"{'written' if written else 'not written'}, "
                f"{time.perf_counter() - t0:.1f} s; {tail}")

    print(run(0), flush=True)
    with ThreadPoolExecutor(args.parallel) as pool:
        for line in pool.map(run, range(1, args.legs)):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
