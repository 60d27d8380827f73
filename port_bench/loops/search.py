"""The serving loop: `SpeechRetriever.search_stream`, closed loop, pipelined.

Set-up builds the image index and warms the stream on the cell's own
shapes. The window hands the cell's batches in turn to one `search_stream`
until its deadline; with a profiler, a few more batches are traced after
it, through a stream of their own, so tracing costs the window nothing.
The window keeps the answers of its first pass over the distinct batches,
and the keyword codes the program chose for them, for the check.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from port_bench.lib import launches, traffic as T
from port_bench.lib.cell import sync
from port_bench.lib.check import query_gaps, search_numbers
from port_bench.lib.trace import traced_hook

__all__ = ["drive", "reference", "check", "control"]


def _stream(retriever, batches, k, depth, stop, ranges, hook=None, handed=None, done=None):
    """Runs one `search_stream` over the batches in turn until `stop(n)`
    holds before the n-th hand-out; yields each (ids, scores) as it comes."""
    def feed():
        n = 0
        while not stop(n + 1):
            with ranges("next batch"):
                b = batches[n % len(batches)]
            n += 1
            if handed is not None:
                handed.append(time.perf_counter())
            if hook is not None:
                hook(n)
            yield b

    stream = retriever.search_stream(feed(), k=k, depth=depth)
    while True:
        with ranges("search_stream"):
            r = next(stream, None)
        if r is None:
            return
        if done is not None:
            done.append(time.perf_counter())
        yield r


def drive(run, profiler=None):
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index

    mix, dev = run.mix, run.device
    k, depth = int(mix["k"]), int(mix["depth"])
    t0 = time.perf_counter()
    sc = SpeechCLIP(run.model, dev)
    imgs = run.images()
    index = build_image_index(sc, imgs, list(range(imgs.shape[0])))
    del imgs
    retriever = SpeechRetriever(sc, index)
    batches = T.search_batches(mix, run.seed, dev)
    run.batches = batches
    run.mark("images_s", t0)

    t0 = time.perf_counter()
    for _ in retriever.search_stream(batches[: depth + 1], k=k, depth=depth):
        pass
    sync(dev)
    run.mark("warmup_s", t0)

    run.reset_peak()
    handed: List[float] = []
    done: List[float] = []
    answers = []
    counted = launches.read()
    run.arm_keywords(len(batches), training=False)
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    for r in _stream(retriever, batches, k, depth, lambda n: time.perf_counter() >= deadline,
                     run.ranges, handed=handed, done=done):
        if len(answers) < len(batches):
            answers.append(r)
    t_end = time.perf_counter()
    run.out["launches_per_step"] = launches.per_step(counted, launches.read(), len(done))
    b = int(mix["batch"])
    lat = [(d - h) * 1e3 for h, d in zip(handed, done)]
    window = t_end - t_start
    run.out.update({
        "window_s": window, "steps": len(done), "batch": b,
        "setup_s": t_start - run.t_process,
        "utterances_per_s": len(done) * b / window,
        "search_p95_ms": float(np.percentile(lat, 95)) if lat else float("nan"),
        "latencies_ms": lat, "attempted": len(handed) * b,
        "failed": (len(handed) - len(done)) * b,
    })
    # a seeded sample of the distinct batches the window answered
    rng = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, 3])
    n = min(int(mix["check"]), len(answers))
    run.check_batches = sorted(rng.choice(len(answers), size=n, replace=False).tolist())
    run.answers = {j: answers[j] for j in run.check_batches}
    run.prog = {"codes": {j: run.codes[j] for j in run.check_batches if j < len(run.codes)}}
    run.read_peak()
    if profiler is not None:
        skip, active = int(mix["trace_skip"]), int(mix["trace_steps"])
        count = skip + active - 1
        with profiler:
            for _ in _stream(retriever, batches, k, depth, lambda n: n > count, run.ranges,
                             hook=traced_hook(profiler, skip, dev, run.ranges)):
                pass
    del sc, index, retriever
    run.free()


def reference(run, prec: str = "fp32", forced=None, index=None):
    """Checked batch -> the reference's cosines of its queries against every
    image of the index (Q, N); the codes it took per batch; its `kw_gap`
    where it took `forced` codes (batch -> (Q * K,)); and the index."""
    model = run.reference_model(prec)
    dev = run.device
    scores, chosen = {}, {}
    with torch.no_grad():
        if index is None:
            imgs = run.images()
            index = model.encode_images(imgs)
            index = index / index.norm(dim=-1, keepdim=True).clamp_min(1e-8)
            del imgs
        for j in run.check_batches:
            wav, lens = T.pad_batch(run.batches[j])
            feat = model.retrieval_feature(torch.from_numpy(wav).to(dev),
                                           torch.from_numpy(lens).to(dev),
                                           forced=None if forced is None else forced[j])
            feat = feat / feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)
            scores[j], chosen[j] = feat @ index.T, model.chosen
    return {"scores": scores, "chosen": chosen,
            "kw_gap": model.kw_gap if forced is not None else None, "index": index}


def _numbers(ref, answers):
    gaps = []
    for j, s in ref["scores"].items():
        ids, got = (torch.as_tensor(a).to(s.device) for a in answers[j])
        gaps.append(query_gaps(s, ids, got))
    return search_numbers(gaps, ref["kw_gap"])


def check(run, free: bool = False) -> dict:
    """The numbers `correct` compares. Where the program chose keyword codes,
    the reference takes them (`kw_gap` judges them); `free` runs the
    reference on its own codes, for the readings only."""
    codes = run.prog["codes"] or None
    if codes is not None and sorted(codes) != run.check_batches:
        return {"kw_gap": float("nan")}  # a checked batch whose codes were not seen
    return _numbers(reference(run, forced=None if free else codes), run.answers)


def _top(scores, k):
    return {j: (t.indices, t.values) for j, t in
            ((j, torch.topk(s, k, dim=-1)) for j, s in scores.items())}


def control(run, say):
    """The control (the reference in float8, judged on its own codes as the
    program is) and two planted faults, against the float32 reference:
    "answer", each query's first answer the image the reference ranks
    k + 1, its score kept; "half", the second half of each batch's rows
    given the first half's answers."""
    run.batches = T.search_batches(run.mix, run.seed, run.device)
    rng = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, 3])
    run.check_batches = sorted(rng.choice(len(run.batches), size=int(run.mix["check"]),
                                          replace=False).tolist())
    k = int(run.mix["k"])
    ref = reference(run, "fp32")
    fp8 = reference(run, "fp8")
    has_codes = next(iter(ref["chosen"].values())) is not None
    judge = reference(run, "fp32", forced=fp8["chosen"], index=ref["index"]) if has_codes \
        else ref
    say({"kind": "fp8", **_numbers(judge, _top(fp8["scores"], k))})
    del fp8, judge
    answer, half = {}, {}
    for j, s in ref["scores"].items():
        top = torch.topk(s, k + 1, dim=-1)
        ids = top.indices[:, :k].clone()
        ids[:, 0] = top.indices[:, k]
        answer[j] = (ids, top.values[:, :k])
        h = s.shape[0] // 2
        ids, vals = top.indices[:, :k].clone(), top.values[:, :k].clone()
        ids[h: 2 * h], vals[h: 2 * h] = ids[:h], vals[:h]
        half[j] = (ids, vals)
    ref["kw_gap"] = 0.0 if has_codes else None
    say({"kind": "answer", **_numbers(ref, answer)})
    say({"kind": "half", **_numbers(ref, half)})
