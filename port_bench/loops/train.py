"""The training loop: `Trainer.fit` over an in-memory feed, closed loop.

Set-up makes the cached image features (the program's image tower over the
seeded pool), drives the first `check` steps through the same `fit` and
feed as the window (what the check compares), and warms up. The window
runs untraced until its deadline; with a profiler, a few more steps are
traced after it, so tracing costs the window nothing. The window's numbers
go into `run.out` under the end-to-end metrics' names.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from typing import List

import torch

from port_bench.lib import launches, traffic as T
from port_bench.lib.cell import sync
from port_bench.lib.check import train_numbers, worst_leaves
from port_bench.lib.trace import traced_hook

__all__ = ["drive", "reference", "check", "control"]


class Feed:
    """The in-memory loader `Trainer.fit` iterates: the cell's batches in
    turn, a counted number of them or until a deadline (the window, which it
    closes by lowering `max_steps` to the steps taken, so that fit returns
    through its own end of pass). `hook(n)` runs before the n-th batch is
    handed out."""

    def __init__(self, batches, trainer, ranges):
        self.batches, self.trainer, self.ranges = batches, trainer, ranges
        self.i, self.given = 0, 0
        self.count = self.deadline = self.hook = None

    def plan(self, count=None, deadline=None, hook=None):
        self.count, self.deadline, self.hook, self.given = count, deadline, hook, 0

    def __iter__(self):
        while True:
            if self.count is not None and self.given >= self.count:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                self.trainer.max_steps = self.trainer.opt_step
                return
            with self.ranges("next batch"):
                batch = self.batches[self.i % len(self.batches)]
            self.i += 1
            self.given += 1
            if self.hook is not None:
                self.hook(self.given)
            yield batch


def pace_line(paces) -> str:
    """The window's pace step by step: the host's interval between
    dispatches and time inside `train_step`, and the device's time from
    one step's start to the next (CUDA events), with the slowest steps."""
    def stats(xs):
        xs = sorted(xs)
        return f"{xs[len(xs) // 2]:.6f}/{xs[-1]:.6f}" if xs else "-"

    host = [b[0] - a[0] for a, b in zip(paces, paces[1:])]
    dispatch = [p[1] for p in paces]
    marks = [p[2] for p in paces if p[2] is not None]
    dev = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    slow = sorted(range(len(dev)), key=lambda i: -dev[i])[:5]
    return (f"[pace] steps={len(paces)} host_gap_s(med/max)={stats(host)} "
            f"dispatch_s(med/max)={stats(dispatch)} device_step_s(med/max)={stats(dev)} "
            f"device_min_s={min(dev) if dev else 0:.6f} "
            f"slowest={[(i, round(dev[i], 6)) for i in slow]}")


def drive(run, profiler=None):
    from speechclip_plus_tpu_torch.tasks.trainer import Trainer
    mix, dev = run.mix, run.device
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
    save = tempfile.mkdtemp(prefix="port_bench_fit_")
    trainer = Trainer(run.model, run.node, save, seed=run.seed)
    n_check = int(mix["check"])
    losses: List[torch.Tensor] = []
    probe = [False]
    inner = trainer.train_step

    paces = []

    def step(state, batch, *a, **k):
        t = time.perf_counter()
        mark = None
        if probe[0] and dev.type == "cuda":
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        with run.ranges("train_step"):
            metrics = inner(state, batch, *a, **k)
        if probe[0]:
            paces.append((t, time.perf_counter() - t, mark))
        if len(losses) < n_check:
            losses.append(metrics["train_loss"].detach().clone())
        return metrics

    trainer.train_step = step
    run.arm_keywords(n_check, training=True)
    feed = Feed(batches, trainer, run.ranges)
    named = [(n, p) for n, p in run.model.named_parameters() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}
    trainer.max_steps = 1
    feed.plan(count=1)
    trainer.fit(feed)
    sync(dev)
    run.mark("first_step_s", t0)
    t0 = time.perf_counter()
    adam = trainer.optimizer.adam
    # the first gradient as Adam holds it: its first moment over (1 - beta1);
    # a tensor Adam never stepped holds none
    grad = {n: adam.state[p]["exp_avg"].detach().clone() / 0.1 if p in adam.state
            else torch.zeros_like(p) for n, p in named}
    trainer.max_steps = n_check
    feed.plan(count=n_check - 1)
    trainer.fit(feed)
    delta = {n: p.detach() - start[n] for n, p in named}
    trainer.max_steps = n_check + int(mix["warmup"])
    feed.plan(count=int(mix["warmup"]))
    trainer.fit(feed)
    run.prog = {"loss": [float(v) for v in losses], "grad": grad, "delta": delta,
                "codes": list(run.codes)}
    del start
    sync(dev)
    run.mark("warmup_s", t0)

    run.reset_peak()
    waits0 = len(trainer.timings["loader_wait_s"])
    trainer.max_steps = 10 ** 9
    counted = launches.read()
    probe[0] = True
    t_start = time.perf_counter()
    feed.plan(deadline=t_start + run.seconds)
    trainer.fit(feed)
    t_end = time.perf_counter()
    probe[0] = False
    print(pace_line(paces), flush=True)
    window, steps = t_end - t_start, feed.given
    run.out["launches_per_step"] = launches.per_step(counted, launches.read(), steps)
    waits = trainer.timings["loader_wait_s"][waits0:]
    run.out.update({
        "window_s": window, "steps": steps, "batch": int(mix["batch"]),
        "setup_s": t_start - run.t_process,
        "pairs_per_s": steps * int(mix["batch"]) / window,
        "loader_wait_s": waits, "attempted": steps, "failed": 0,
    })
    run.read_peak()
    if profiler is not None:
        skip, active = int(mix["trace_skip"]), int(mix["trace_steps"])
        count = skip + active - 1
        trainer.max_steps = trainer.opt_step + count
        feed.plan(count=count, hook=traced_hook(profiler, skip, dev, run.ranges))
        with profiler:
            trainer.fit(feed)
    del trainer, feed, named, inner
    shutil.rmtree(save, ignore_errors=True)
    run.free()


def reference(run, prec: str = "fp32", fault: str = None, forced=None) -> dict:
    """The reference's first steps: {'loss', 'grad', 'raw_grad', 'delta',
    'chosen'} (and 'kw_gap' with `forced` codes)."""
    from port_bench.reference.train import reference_steps

    model = run.reference_model(prec)
    dev = run.device
    n = int(run.mix["check"])
    with torch.no_grad():
        imgs = run.images()
        used = sorted({int(i) for b in run.batches[:n] for i in b["id"]})
        feats = torch.zeros(imgs.shape[0], model.W["clip.visual.proj"].shape[1], device=dev)
        feats[used] = model.encode_images(imgs[used])
    del imgs
    batches = []
    for b in run.batches[:n]:
        ids = torch.from_numpy(b["id"]).long().to(dev)
        batches.append({"wav": torch.from_numpy(b["wav"]).to(dev),
                        "wav_len": torch.from_numpy(b["wav_len"]).long().to(dev),
                        "id": ids, "image_feat": feats[ids]})
    y = run.cfg["yaml"]
    optim = dict(y["audio_encoder"]["optim"]["args"], **y["audio_encoder"]["scheduler"],
                 gradient_clip_val=y["trainer"]["gradient_clip_val"])
    ref = reference_steps(model, batches, run.seed, optim, n, fault=fault, forced=forced)
    ref["delta"] = {k: model.W[k] - v for k, v in ref["start"].items()}
    return ref


def check(run, free: bool = False) -> dict:
    """The numbers `correct` compares. Where the program chose keyword codes,
    the reference takes them (`kw_gap` judges them); `free` runs the
    reference on its own codes, for the readings only."""
    codes = run.prog["codes"] or None
    run.ref = reference(run, forced=None if free else codes)
    return train_numbers(run.prog, run.ref)


def control(run, say):
    """The control (the reference in float8, judged on its own codes as the
    program is) and the planted "half" fault, each against the float32
    reference; a state left unchanged reads 1 on `step_gap` by construction."""
    run.batches = T.train_batches(run.mix, run.seed, run.device)
    ref = reference(run, "fp32")
    fp8 = reference(run, "fp8")
    has_codes = ref["chosen"][0] is not None
    forced = reference(run, "fp32", forced=fp8["chosen"]) if has_codes else ref
    say({"kind": "fp8", **train_numbers(fp8, forced), "worst": worst_leaves(fp8, forced)})
    del fp8, forced
    half = reference(run, fault="half")
    say({"kind": "half", **train_numbers(half, ref), "worst": worst_leaves(half, ref)})
