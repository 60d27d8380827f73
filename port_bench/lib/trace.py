"""The device's timeline from a torch.profiler trace, reduced to numbers.

The traced run profiles a fixed number of steady steps (or batches) after
the measured window, with a `torch.profiler` schedule that records CUDA
activity alone (CPU op recording would put its own host cost into the
traced steps and their idle share), and exports the Chrome trace once.
The benchmark's own host ranges ("next batch", "train_step",
"search_stream") are kept by the run's `HostRanges` on the wall clock, which the
trace's timestamps share (`baseTimeNanoseconds` + `ts`). From them: device
intervals (kernels, copies and sets), their union (busy seconds) over the
span from the first to the last (the traced window), device time by kernel
name, and the longest idle gaps labelled by the innermost host range open
when the gap began.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

__all__ = ["HOST_RANGES", "HostRanges", "Timeline", "profile_schedule", "traced_hook",
           "timeline"]

HOST_RANGES = ("next batch", "train_step", "search_stream")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class HostRanges:
    """The benchmark's host ranges as (start ns, end ns, name) on the wall
    clock, kept once `on` (the traced steps) and free of cost before:
    `with ranges("next batch"): ...`."""

    def __init__(self):
        self.on, self.spans = False, []

    def __call__(self, name: str):
        return _Range(self, name)


class _Range:
    def __init__(self, ranges, name):
        self.ranges, self.name = ranges, name

    def __enter__(self):
        self.t0 = time.time_ns() if self.ranges.on else 0

    def __exit__(self, *exc):
        if self.ranges.on:
            self.ranges.spans.append((self.t0, time.time_ns(), self.name))


class Timeline:
    """Device intervals (us) of one traced window and what ran in them;
    `host`: the benchmark's (start us, end us, name) ranges on the trace's
    clock."""

    def __init__(self, events: Sequence[dict], host: Sequence[tuple] = ()):
        dev = []
        for e in events:
            if e.get("ph") == "X" and "dur" in e and e.get("cat", "") in _DEVICE_CATS:
                dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
        dev.sort()
        self.device = dev
        self.host = sorted(h for h in host if h[2] in HOST_RANGES)

    @staticmethod
    def from_profiler(prof, ranges: HostRanges) -> "Timeline":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        if not isinstance(data, dict):
            return Timeline(data)
        base = int(data.get("baseTimeNanoseconds", 0))
        host = [((a - base) * 1e-3, (b - base) * 1e-3, n) for a, b, n in ranges.spans]
        return Timeline(data.get("traceEvents", []), host)

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def window_s(self) -> float:
        if not self.device:
            return 0.0
        return (max(e for _, e, _ in self.device) - self.device[0][0]) * 1e-6

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) * 1e-6

    def by_name(self) -> Dict[str, float]:
        """Device seconds by kernel (or copy) name."""
        out: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            out[name] += (e - s) * 1e-6
        return dict(out)

    def seconds_matching(self, patterns: Sequence[str]) -> float:
        """Device seconds in names holding any of `patterns`."""
        return sum(sec for name, sec in self.by_name().items()
                   if any(p in name for p in patterns))

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.by_name().items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between device activity, each labelled by the
        innermost benchmark range open on the host when it began."""
        merged = self._merged()
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            label, width = "other host work", None
            for hs, he, name in self.host:
                if hs <= s < he and (width is None or he - hs < width):
                    label, width = name, he - hs
            out.append([label, (e - s) * 1e-6])
        return out


def profile_schedule(skip: int, active: int):
    """A profiler that skips `skip` steps, warms one, records `active`, and
    a dict that holds it once its record is ready (`timeline` reads it)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
            else torch.profiler.ProfilerActivity.CPU]
    holder = {}

    def ready(prof):  # exported after the window, so the export costs it nothing
        holder["profiler"] = prof

    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=ready,
        schedule=torch.profiler.schedule(wait=max(skip - 1, 0), warmup=1, active=active,
                                         repeat=1))
    return prof, holder


def traced_hook(profiler, skip: int, device, ranges: HostRanges):
    """A loop's hook before its n-th hand-out: steps the profiler; the device
    is drained before the first recorded batch (the `skip`-th), so that the
    trace holds the recorded batches' work and nothing of earlier ones; the
    host ranges are kept from the first hand-out on."""
    import torch

    def hook(n):
        ranges.on = True
        if n == skip and device.type == "cuda":
            torch.cuda.synchronize(device)
        profiler.step()
    return hook


def timeline(holder, ranges: HostRanges) -> "Timeline":
    """The traced window of a `profile_schedule` profiler, or None."""
    prof = holder.get("profiler")
    return None if prof is None else Timeline.from_profiler(prof, ranges)
