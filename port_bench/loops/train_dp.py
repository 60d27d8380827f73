"""The data-parallel training loop: `ranks` processes on one host, one card
each, through `Trainer.fit`, closed loop, measured on rank 0.

Rank 0 is the benchmark's own process; `drive` starts ranks 1 .. W-1 as
processes of this file (each builds the model from the seed on its card)
and joins them to one process group under the environment `run_task
--devices W` gives its ranks (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT; NCCL on the card, gloo on the CPU), through the program's
`maybe_initialize_distributed`. Every rank iterates the same global batches
of the traffic mix (`batch` rows, the configuration's global batch); the
trainer takes each rank's contiguous rows, so a rank trains `batch` / W.

Set-up and the traced steps run counted plans of optimizer steps, the same
on every rank. The window ends at rank 0's deadline through the trainer's
own stop at an optimizer-step boundary (its preemption flag, all-reduced
over the ranks at each boundary and read at the next), so every rank stops
after the same step; the stop writes no checkpoint here. `pairs_per_s` is
the global pairs of the steps rank 0 trained in its window over the
window's seconds, ended by a synchronise; `batch` in the window's numbers is
a rank's rows, the batch rank 0's per-layer readers see.

`check` and `control` are `train.check` and `train.control` against the
one-device reference over the global batch, each rank's rows with that
rank's dropout stream (`rank_generator`), the keyword codes every rank
chose gathered in rank order; the control adds the exchange between the
ranks left out ("noexchange").
"""
from __future__ import annotations

import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.lib import launches, traffic as T  # noqa: E402
from port_bench.lib.cell import Run, sync  # noqa: E402
from port_bench.lib.check import train_numbers, worst_leaves  # noqa: E402
from port_bench.lib.trace import traced_hook  # noqa: E402
from port_bench.loops import train  # noqa: E402
from port_bench.reference.model import Model  # noqa: E402

__all__ = ["drive", "check", "control", "rank_generator"]

_M32 = 0xFFFFFFFF


def rank_generator(seed: int, step: int, rank: int, device) -> torch.Generator:
    """The dropout generator of micro-step `step` on rank `rank`, a frozen copy
    of the program's scheme: numpy's SeedSequence over (seed & 0xFFFFFFFF,
    step), rank r > 0 its child (0, r); rank 0's is the one-device stream."""
    key = () if rank == 0 else (0, int(rank))
    state = np.random.SeedSequence([int(seed) & _M32, int(step)],
                                   spawn_key=key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Ranks(Model):
    """The reference over a global batch whose rows are split over `world`
    ranks: each rank's contiguous rows through the tower, the branch's
    attention and CIF with that rank's dropout stream, then the keyword
    head (batch statistics over every row), the text tower and the loss over
    the global batch. Training of the hybrid+ branch, one micro-step an
    optimizer step."""

    def __init__(self, model: Model, seed: int, world: int):
        super().__init__(model.W, model.a, model.p, model.rb)
        self.seed, self.world = int(seed), int(world)

    def speech_features(self, wav, wav_len, *, train=False, gen=None, step=0,
                        want=("cascaded", "parallel"), forced=None):
        A = self.a
        if not train:
            return super().speech_features(wav, wav_len, want=want, forced=forced)
        if A["branch"]["type"] != "HybridBranch_plus":
            raise NotImplementedError(f"branch {A['branch']['type']!r} over ranks")
        per = wav.shape[0] // self.world
        parts = []
        for r in range(self.world):
            rows = slice(r * per, (r + 1) * per)
            g = rank_generator(self.seed, step, r, wav.device)
            feat, feat_len = self.tower(wav[rows], wav_len[rows], g, True)
            h, pad = self._branch_attention(feat, feat_len, self.W["cascaded_branch.cls"],
                                            A["branch"]["heads"], g, True)
            parallel = F.linear(h[:, 0], self.W["cascaded_branch.parallel_proj.weight"],
                                self.W["cascaded_branch.parallel_proj.bias"])
            parts.append((parallel,) + self._cif(h[:, 1:], pad[:, 1:], feat_len, step, g, True))
        parallel, slots, count, quantity, target = (torch.cat(x) for x in zip(*parts))
        kw = self._keyword_head(slots, True, None, forced)
        return {"parallel": parallel, "cascaded": self.encode_keywords(kw, count),
                "quantity": quantity, "target": target}


def _ranked(run):
    """The run's reference model: `Ranks` over `Run.reference_model`'s."""
    world = int(run.mix["ranks"])
    run.reference_model = lambda prec="fp32": Ranks(Run.reference_model(run, prec), run.seed,
                                                    world)


def check(run, free: bool = False) -> dict:
    _ranked(run)
    return train.check(run, free)


def control(run, say):
    """`train.control` over the ranks, and the planted "noexchange" fault:
    rank 0 alone, its own rows with its own stream, keyword statistics, loss
    and gradient (no all-reduce, no gather), against the global reference."""
    _ranked(run)
    train.control(run, say)
    ref = train.reference(run)
    per = int(run.mix["batch"]) // int(run.mix["ranks"])
    run.batches = [{k: v[:per] for k, v in b.items()} for b in run.batches]
    run.reference_model = lambda prec="fp32": Run.reference_model(run, prec)
    local = train.reference(run)
    say({"kind": "noexchange", **train_numbers(local, ref), "worst": worst_leaves(local, ref)})


class _Feed(train.Feed):
    """`train.Feed` whose deadline raises the trainer's stop flag and keeps
    handing out batches: the ranks stop at the same optimizer step."""

    def __iter__(self):
        while True:
            if self.count is not None and self.given >= self.count:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                self.trainer._preempt_signum = "deadline"
                self.deadline = None
            with self.ranges("next batch"):
                batch = self.batches[self.i % len(self.batches)]
            self.i += 1
            self.given += 1
            if self.hook is not None:
                self.hook(self.given)
            yield batch


def _gather_codes(codes: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each checked step's codes of every rank, in rank order."""
    import torch.distributed as dist

    out = []
    for c in codes:
        parts = [torch.empty_like(c) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, c.contiguous())
        out.append(torch.cat(parts))
    return out


def _rank_drive(run, traced: bool, profiler=None):
    """One rank's set-up, window and traced steps; rank 0 keeps the numbers."""
    import torch.distributed as dist
    from speechclip_plus_tpu_torch.tasks.trainer import Trainer

    mix, dev = run.mix, run.device
    leader = dist.get_rank() == 0
    t0 = time.perf_counter()
    with torch.no_grad():
        imgs = run.images()
        pool = torch.cat([run.model.encode_image_raw(imgs[i: i + 250]).float()
                          for i in range(0, imgs.shape[0], 250)]).cpu().numpy()
    del imgs
    batches = T.train_batches(mix, run.seed, dev)
    for b in batches:
        b["image_feat"] = pool[b["id"]]
    run.batches = batches
    run.mark("images_s", t0)

    t0 = time.perf_counter()
    save = tempfile.mkdtemp(prefix="port_bench_dp_")
    trainer = Trainer(run.model, run.node, save, seed=run.seed)
    trainer._preempt_save = lambda batches_done: None  # the window's end writes nothing
    n_check = int(mix["check"])
    losses: List[torch.Tensor] = []
    inner = trainer.train_step

    def step(state, batch, *a, **k):
        with run.ranges("train_step"):
            metrics = inner(state, batch, *a, **k)
        if len(losses) < n_check:
            losses.append(metrics["train_loss"].detach().clone())
        return metrics

    trainer.train_step = step
    run.arm_keywords(n_check, training=True)
    feed = _Feed(batches, trainer, run.ranges)
    named = [(n, p) for n, p in run.model.named_parameters() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}
    trainer.max_steps = 1
    feed.plan(count=1)
    trainer.fit(feed)
    sync(dev)
    run.mark("first_step_s", t0)
    t0 = time.perf_counter()
    adam = trainer.optimizer.adam
    grad = {n: adam.state[p]["exp_avg"].detach().clone() / 0.1 if p in adam.state
            else torch.zeros_like(p) for n, p in named}
    trainer.max_steps = n_check
    feed.plan(count=n_check - 1)
    trainer.fit(feed)
    delta = {n: p.detach() - start[n] for n, p in named}
    codes = _gather_codes(run.codes) if run.codes else []
    trainer.max_steps = n_check + int(mix["warmup"])
    feed.plan(count=int(mix["warmup"]))
    trainer.fit(feed)
    run.prog = {"loss": [float(v) for v in losses], "grad": grad, "delta": delta,
                "codes": codes}
    del start
    sync(dev)
    run.mark("warmup_s", t0)

    run.reset_peak()
    waits0 = len(trainer.timings["loader_wait_s"])
    trainer.max_steps = 10 ** 9
    counted = launches.read()
    s0 = int(trainer.state.step)
    t_start = time.perf_counter()
    feed.plan(deadline=t_start + run.seconds if leader else None)
    trainer.fit(feed)
    sync(dev)
    t_end = time.perf_counter()
    trainer._preempt_signum = None
    steps, world = int(trainer.state.step) - s0, dist.get_world_size()
    window = t_end - t_start
    run.out["launches_per_step"] = launches.per_step(counted, launches.read(), steps)
    run.out.update({
        "window_s": window, "steps": steps, "batch": int(mix["batch"]) // world,
        "setup_s": t_start - run.t_process,
        "pairs_per_s": steps * int(mix["batch"]) / window,
        "loader_wait_s": trainer.timings["loader_wait_s"][waits0:],
        "attempted": steps, "failed": 0,
    })
    run.read_peak()
    if traced:
        skip, active = int(mix["trace_skip"]), int(mix["trace_steps"])
        count = skip + active - 1
        trainer.max_steps = trainer.opt_step + count
        if profiler is None:
            feed.plan(count=count)
            trainer.fit(feed)
        else:
            feed.plan(count=count, hook=traced_hook(profiler, skip, dev, run.ranges))
            with profiler:
                trainer.fit(feed)
    sync(dev)
    del trainer, feed, named, inner
    shutil.rmtree(save, ignore_errors=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _watch(procs, logs, stop):
    """Ends this process when a rank fails, with that rank's log, so that
    rank 0 fails at once instead of waiting in a collective."""
    while not stop.is_set():
        for p, log in zip(procs, logs):
            if p.poll() not in (None, 0):
                with open(log) as f:
                    sys.stderr.write(f.read()[-8000:])
                sys.stderr.write(f"port_bench: rank process {p.args[-1]} exited {p.returncode}\n")
                sys.stderr.flush()
                os._exit(5)
        if all(p.poll() is not None for p in procs):
            return
        time.sleep(1.0)


def drive(run, profiler=None):
    import torch.distributed as dist
    from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed

    world, port = int(run.mix["ranks"]), _free_port()
    tmp = tempfile.mkdtemp(prefix="port_bench_ranks_")
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"cfg": run.cfg, "mix": run.mix, "seed": run.seed, "seconds": run.seconds,
                   "kind": run.device.type, "traced": profiler is not None}, f)
    # the ranks import the program from where this process found it
    program = os.path.dirname(os.path.dirname(os.path.abspath(
        importlib.import_module("speechclip_plus_tpu_torch").__file__)))
    path = os.pathsep.join([ROOT, program] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs, logs = [], []
    for r in range(1, world):
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec, str(r)], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=path, **_env(r, world, port)), stdout=out,
                stderr=subprocess.STDOUT))
    stop = threading.Event()
    threading.Thread(target=_watch, args=(procs, logs, stop), daemon=True).start()
    saved = {k: os.environ.get(k) for k in _env(0, world, port)}
    os.environ.update(_env(0, world, port))
    try:
        maybe_initialize_distributed(device=run.device.type)
        _rank_drive(run, profiler is not None, profiler)
    except BaseException:
        stop.set()
        for p in procs:
            p.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    for p in procs:
        p.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    run.free()


def _rank_main(spec_path: str, rank: int):
    """A rank other than 0: the model from the seed on its device, the group,
    the same plans as rank 0."""
    from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    device = f"cuda:{rank}" if spec["kind"] == "cuda" else "cpu"
    run = Run(spec["cfg"], spec["mix"], spec["seed"], spec["seconds"], device)
    run.build()
    maybe_initialize_distributed(device=spec["kind"])
    _rank_drive(run, spec["traced"])
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
