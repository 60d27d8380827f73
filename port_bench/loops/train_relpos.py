"""The training loop of a WavLM configuration: `loops/train.py`'s closed loop
through `Trainer.fit`, held to `reference/wavlm.py`.

`drive` is `train.drive` with two adapters for `accumulate_grad_batches`
k > 1: the feed's counted plans count optimizer steps (k micro-batches
each), and the keyword codes of every micro-step of the checked optimizer
steps are recorded. The window still ends at its deadline, between any two
micro-batches, and counts micro-batches of B pairs each. `check` and
`control` are `train.check` and `train.control` over the WavLM reference
with accumulation; the control adds two planted faults of the tower, the
ungated bias ("nogate") and no relative bias ("nobias").

The numbers of `lib/check.py` read the trainable branch, downstream of the
frozen tower, and at seeded weights the gate moves them less than the
program's bf16 does. So the check also compares the tower itself, on the
first micro-step, in training with its dropout:

  tower_gap  the norm of the gap between the program's weighted-sum feature
             (B, T', D) and the reference's, over the reference's norm;
  attn0_gap  the same for layer 0's self-attention output (B, T', D), out-
             projected, before the residual's dropout: where the gate acts,
             before 23 more layers of bf16 rounding bury what it does.
"""
from __future__ import annotations

import contextlib

import torch

from port_bench.lib import traffic as T
from port_bench.lib.check import train_numbers, worst_leaves
from port_bench.lib.weights import make_weights
from port_bench.loops import train

__all__ = ["drive", "reference", "check", "control"]


def _accum(run) -> int:
    return max(int(run.cfg["yaml"]["trainer"].get("accumulate_grad_batches", 1) or 1), 1)


class _StepFeed(train.Feed):
    """`train.Feed` whose counted plans are optimizer steps."""

    def plan(self, count=None, deadline=None, hook=None):
        super().plan(None if count is None else count * self.trainer.accum, deadline, hook)


@contextlib.contextmanager
def _accumulating(run):
    k, feed, arm = _accum(run), train.Feed, run.arm_keywords
    run.arm_keywords = lambda calls, training: arm(calls * k, training)
    train.Feed = _StepFeed
    try:
        yield
    finally:
        train.Feed, run.arm_keywords = feed, arm


def _record_tower(run):
    """Keeps the tower's feature of the model's first `forward_audio` call (the
    first micro-step's) on the host as `run.tower_feat`, and layer 0's
    self-attention output of that call as `run.attn0`."""
    inner, run.tower_feat = run.model.forward_audio, None
    layer = run.model.get_submodule("audio_encoder.layers.0")
    attention, run.attn0 = layer.attention, None

    def forward_audio(*a, **k):
        out = inner(*a, **k)
        if run.tower_feat is None:
            run.tower_feat = out[0].detach().float().cpu()
        return out

    def attn0(*a, **k):
        out = attention(*a, **k)
        if run.attn0 is None:
            run.attn0 = out.detach().float().cpu()
        return out

    run.model.forward_audio, layer.attention = forward_audio, attn0


def drive(run, profiler=None):
    _record_tower(run)
    with _accumulating(run):
        train.drive(run, profiler)


def gap(feat: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((feat.to(ref.device).float() - ref).norm() / ref.norm())


def tower_gaps(out: dict, ref: dict) -> dict:
    """`tower_gap` and `attn0_gap` of one output's {'tower_feat', 'attn0'}
    against the reference's."""
    return {"tower_gap": gap(out["tower_feat"], ref["tower_feat"]),
            "attn0_gap": gap(out["attn0"], ref["attn0"])}


def reference(run, prec: str = "fp32", fault: str = None, forced=None) -> dict:
    """The reference's first optimizer steps (`reference.wavlm.accumulated_steps`);
    `fault` "half", "nogate" or "nobias"."""
    from port_bench.reference.model import Prec, kw_bn_init, log_inv_temp
    from port_bench.reference.wavlm import WavLM, accumulated_steps

    cfg, dev = run.cfg, run.device
    W = {n: t.float() for n, t in make_weights(run.spec, run.seed, dev).items()}
    kw_bn_init(W, cfg["arch"])
    W["criterion_log_inv_temp"] = log_inv_temp(
        float(cfg["yaml"]["cl_loss"]["args"]["temperature"])).to(dev)
    model = WavLM(W, cfg["arch"], Prec(prec), gate=fault not in ("nogate", "nobias"),
                  bias=fault != "nobias")
    first, attn0 = [], []
    inner, attention = model.tower, model.self_attention

    def tower(*a, **k):  # keeps the first micro-step's feature
        out = inner(*a, **k)
        if not first:
            first.append(out[0].detach())
        return out

    def self_attention(x, pre, *a, **k):  # and its layer 0's attention output
        out = attention(x, pre, *a, **k)
        if not attn0 and pre == "audio_encoder.layers.0.self_attn.":
            attn0.append(out.detach())
        return out

    model.tower, model.self_attention = tower, self_attention
    k, n = _accum(run), int(run.mix["check"])
    micro = [run.batches[i % len(run.batches)] for i in range(n * k)]  # the feed cycles them
    with torch.no_grad():
        imgs = run.images()
        used = sorted({int(i) for b in micro for i in b["id"]})
        feats = torch.zeros(imgs.shape[0], W["clip.visual.proj"].shape[1], device=dev)
        feats[used] = model.encode_images(imgs[used])
    del imgs
    batches = []
    for b in micro:
        ids = torch.from_numpy(b["id"]).long().to(dev)
        batches.append({"wav": torch.from_numpy(b["wav"]).to(dev),
                        "wav_len": torch.from_numpy(b["wav_len"]).long().to(dev),
                        "id": ids, "image_feat": feats[ids]})
    y = cfg["yaml"]
    optim = dict(y["audio_encoder"]["optim"]["args"], **y["audio_encoder"]["scheduler"],
                 gradient_clip_val=y["trainer"]["gradient_clip_val"])
    ref = accumulated_steps(model, batches, run.seed, optim, n, k,
                            fault="half" if fault == "half" else None, forced=forced)
    ref["delta"] = {name: model.W[name] - v for name, v in ref["start"].items()}
    ref["loss"] = ref["loss"][:n]
    ref["tower_feat"], ref["attn0"] = first[0], attn0[0]
    return ref


def check(run, free: bool = False) -> dict:
    """`train.check` over the WavLM reference: the program's first micro-steps'
    losses, its first optimizer step's gradient and the change over the
    checked optimizer steps, the reference taking the program's codes."""
    codes = run.prog["codes"] or None
    run.ref = reference(run, forced=None if free else codes)
    return dict(train_numbers(run.prog, run.ref),
                **tower_gaps({"tower_feat": run.tower_feat, "attn0": run.attn0}, run.ref))


def control(run, say):
    """`train.control` over the WavLM reference, and the tower's faults: the
    reference without the gate and without the relative bias, each on the
    fp32 reference's codes."""
    run.batches = T.train_batches(run.mix, run.seed, run.device)
    ref = reference(run, "fp32")
    fp8 = reference(run, "fp8")
    forced = reference(run, "fp32", forced=fp8["chosen"])
    say({"kind": "fp8", **train_numbers(fp8, forced), **tower_gaps(fp8, ref),
         "worst": worst_leaves(fp8, forced)})
    del fp8, forced
    for fault in ("half", "nogate", "nobias"):
        bad = reference(run, fault=fault, forced=None if fault == "half" else ref["chosen"])
        line = train_numbers(bad, ref)
        line.pop("kw_gap", None)
        say({"kind": fault, **line, **tower_gaps(bad, ref), "worst": worst_leaves(bad, ref)})
        del bad
