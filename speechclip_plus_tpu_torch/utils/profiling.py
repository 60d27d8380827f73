"""Profiling hooks (port of ``speechclip_plus_tpu/utils/profiling.py``).

Thin wrappers over `torch.profiler`: capture a trace of any code region
(written as Chrome trace JSON, viewable in Perfetto), annotate named spans,
and a step timer for quick throughput numbers that synchronizes the device
before it reads the clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: `with trace("traces"): step(...)` writes
    `<log_dir>/trace_<pid>_<n>.json`; the CUDA activity is recorded when a
    card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named span that shows up in the trace timeline."""
    return torch.profiler.record_function(name)


def _sync(obj) -> None:
    """Wait for the device work behind `obj`: a CUDA event, a tensor (its
    device's stream), or a dict / list / tuple of them."""
    if isinstance(obj, torch.cuda.Event):
        obj.synchronize()
    elif isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _sync(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _sync(v)


class StepTimer:
    """Wall-clock steps/sec + pairs/sec with device sync: the first `tick`
    starts the clock, every later one counts a step."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._steps = 0

    def tick(self, sync_on=None) -> None:
        if sync_on is not None:
            _sync(sync_on)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        else:
            self._steps += 1

    @property
    def steps_per_sec(self) -> float:
        if not self._steps or self._t0 is None:
            return 0.0
        return self._steps / (time.perf_counter() - self._t0)

    @property
    def pairs_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size
