"""The benchmark of `speechclip_plus_tpu_torch` on one NVIDIA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Everything a cell needs is found by name
from ``BENCHMARK.json``: the configuration's file, the traffic mix
``port_bench/traffic/<traffic>.json``, the limits of the correctness check
``port_bench/limits/<cell>.json``, the mix's loop
``port_bench/loops/<loop>.py`` and, with ``--trace 1``, each per-layer
metric's reader ``port_bench/metrics/<metric>.py`` (or the reader of its
family, ``<metric up to the first dot>.py``). The last line of standard
output is the result, one JSON object.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "speechclip_plus_tpu")
PROGRAM = "speechclip_plus_tpu_torch"


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"port_bench: no {what} named {name!r} in BENCHMARK.json")


def resolve_cell(root, name):
    """(benchmark, cell, configuration, mix, limits) of a cell, by name."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cell = _by_name(bench["workloads"], name, "workload")
    entry = _by_name(bench["configs"], cell["config"], "config")
    cfg = _load_json(os.path.join(root, entry["file"]))
    mix = _load_json(os.path.join(root, "port_bench", "traffic", cell["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, "port_bench", "limits", name + ".json"))
    return bench, cell, cfg, mix, limits


def applies(metric, cell_name, reported=()):
    """Whether a metric belongs in a cell's line: the cells its `workloads`
    name, else every cell (an end-to-end metric) or every cell that reports
    the end-to-end metric it `moves` (a per-layer one)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def _load(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root, name):
    """A per-layer metric's reader: ``metrics/<name>.py``, else the reader
    of its family, ``metrics/<name up to the first dot>.py``."""
    d = os.path.join(root, "port_bench", "metrics")
    for stem in (name, name.split(".")[0]):
        path = os.path.join(d, stem + ".py")
        if os.path.exists(path):
            return _load(path, "port_bench_metric_" + stem.replace(".", "_")).read
    raise SystemExit(f"port_bench: no reader for the metric {name!r} in {d}")


def load_loop(root, name):
    """A traffic mix's loop, ``loops/<loop>.py``: `drive(run, profiler)`,
    `check(run)`, `control(run, say)`."""
    return _load(os.path.join(root, "port_bench", "loops", name + ".py"),
                 "port_bench_loop_" + name)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def measure(root, args, device, say=print):
    """Runs a cell on `device`; returns the result dict (the last line)."""
    import torch

    from port_bench.lib.cell import Run, no_tf32
    from port_bench.lib.check import judge
    from port_bench.lib.trace import profile_schedule, timeline

    bench, cell, cfg, mix, limits = resolve_cell(root, args.workload)
    loop = load_loop(root, mix["loop"])
    run = Run(cfg, mix, args.seed, args.seconds, device, t_process=T_PROCESS)
    run.build()
    profiler = holder = None
    if args.trace:
        profiler, holder = profile_schedule(int(run.mix["trace_skip"]),
                                            int(run.mix["trace_steps"]))
    loop.drive(run, profiler)
    out = run.out
    counts = out["launches_per_step"]
    say("[setup] " + " ".join(f"{k}={v:.4f}" for k, v in run.setup.items())
        + f" total_s={out['setup_s']:.4f}")
    say(f"[window] window_s={out['window_s']:.6f} steps={out['steps']} batch={out['batch']} "
        f"launches_per_step={json.dumps(counts)}")
    name = torch.cuda.get_device_name(device) if run.device.type == "cuda" else "cpu"
    if run.device.type == "cuda":
        say(f"[card] {_power_limit()}")
    e2e = [m for m in bench["end_to_end"] if applies(m, cell["name"])]
    steps = int(run.mix.get("trace_steps", 0))
    ctx = {"out": out, "cfg": cfg, "model_cfg": run.mcfg, "mix": run.mix,
           "device_name": name, "launches_per_step": counts, "say": say,
           "timeline": timeline(holder, run.ranges) if holder else None, "trace_steps": steps}
    metrics = {}
    if args.trace:
        reported = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if applies(m, cell["name"], reported):
                value = load_reader(root, m["name"])(dict(ctx, metric=m["name"]))
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in out:
                metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": name,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(out.get("memory_peak_bytes", 0))}
    breakdown = None
    tl = ctx["timeline"]
    if tl is not None:
        device_info["busy_s"] = tl.busy_s()
        device_info["window_s"] = tl.window_s()
        breakdown = {"device_ops": tl.top_ops(10), "idle_gaps": tl.idle_gaps(10)}
        # the traced batches run after the window, under the profiler's own
        # host cost: their pace beside the window's
        say(f"[overhead] window_step_s={out['window_s'] / max(out['steps'], 1):.6f} "
            f"traced_step_s={tl.window_s() / max(steps, 1):.6f} "
            f"traced_busy_step_s={tl.busy_s() / max(steps, 1):.6f}")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")
    with no_tf32():
        numbers = loop.check(run)
    correct, table = judge(numbers, limits)
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"port_bench: the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2
    _, cell, _, _, _ = resolve_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    try:
        result = measure(ROOT, args, "cuda:0", say=lambda s: print(s, flush=True))
    except RuntimeError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
