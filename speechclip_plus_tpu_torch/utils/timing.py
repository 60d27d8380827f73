"""Device timing for the measurement scripts (port of
``speechclip_plus_tpu/utils/timing.py``).

`timed` keeps the JAX helper's contract of calls (one first call, then
`iters` measurements of `chain` calls each) and returns the least mean
seconds per call; `median_ms` is the smoke's kernel timer, the median of
CUDA-event times. CUDA work is timed with CUDA events, which bracket the
calls on the stream; CPU tensors with `time.perf_counter`.

Left out on purpose: the JAX helper's remote-runtime workarounds, which
threaded an `eps` scalar through every call so that a memoizing runtime
could not return a cached result, and synced by a value fetch because
`block_until_ready` did not drain that runtime's queue. A CUDA stream
re-runs every launch, and an event's `synchronize` waits for the work
before it, so `fn` here takes only its own arguments.
"""
from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch

__all__ = ["sync_value", "timed", "median_ms"]


def sync_value(x) -> float:
    """Force the device's work up to `x` with a value fetch (non-scalars are
    summed in fp32)."""
    return float(torch.as_tensor(x).float().sum().item())


def _on_cuda(objs) -> bool:
    def walk(o):
        if isinstance(o, torch.Tensor):
            yield o.is_cuda
        elif isinstance(o, (list, tuple)):
            for v in o:
                yield from walk(v)
        elif isinstance(o, dict):
            for v in o.values():
                yield from walk(v)
    return any(walk(objs))


def timed(fn: Callable, *args, iters: int = 3, chain: int = 5, label: str = "") -> float:
    """Min-of-`iters` mean seconds per call of `fn(*args)`.

    The first call warms up (builds kernels, fills caches); each of the
    `iters` measurements then times `chain` calls in a row, synchronized
    once at the end. CUDA events time the calls where `fn`'s arguments or
    first result hold a CUDA tensor, `time.perf_counter` otherwise."""
    if label:
        print(f"[{time.strftime('%H:%M:%S')}] warming up {label} ...", flush=True)
    first = fn(*args)
    cuda = _on_cuda(args) or _on_cuda(first)
    if cuda:
        torch.cuda.synchronize()
    times: List[float] = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / chain)
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                fn(*args)
            times.append((time.perf_counter() - t0) / chain)
    if label:
        print(f"[{time.strftime('%H:%M:%S')}] {label}: {min(times) * 1e3:.2f} ms", flush=True)
    return min(times)


def median_ms(fn: Callable[[], object], runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` on the current CUDA stream over `runs`
    calls after `warmup` untimed ones, each call between two CUDA events.
    Raises without a CUDA device: no CPU clock stands in for the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("median_ms times CUDA work and this machine has no CUDA device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
