"""Profiling: the port's tracer, trace capture and a step timer (port of
``speechclip_plus_tpu/utils/profiling.py``).

`span(name, **attrs)` marks a region of the program: `with span("tower"):`.
The tracer is on exactly while a `torch.profiler` records
(`torch.autograd._profiler_enabled()`): `trace` below, or any caller's
profiler. Off, a span site costs that one check and a branch: no CUDA event,
no hook, no `record_function`, nothing kept. On, each span

- enters `torch.profiler.record_function(name)`, so a CPU-activity trace
  shows the same names;
- reads the host clock (`time.time_ns`) at entry and exit, and records a CUDA
  event on the current stream at each, resolved only by `recorded()` after a
  synchronise, so tracing adds no host wait inside a step. The events are
  mapped onto the host clock through one anchor taken when recording starts
  (synchronise, record an event, read `time.time_ns`), the clock of the Chrome
  trace's `baseTimeNanoseconds` + `ts`;
- counts the synchronising CUDA calls made while it is the innermost open
  span of its thread: torch's sync debug mode is set to "warn" while
  recording and put back after, and each of its warnings is captured, not
  shown.

A span's parent is the innermost span open on its thread. A `step` (training
micro-step) or `request` (serving request) attribute names the unit of work
and is inherited from the parent. `backward_span` times a module's backward
on autograd's thread: a grad hook on the module's outputs opens it and one
over its inputs and parameters closes it; its parent is the span open on the
thread that ran the forward. Spans are kept in memory, at most `MAX_SPANS`,
with a count of those dropped (`dropped()`); nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence

import torch

__all__ = ["trace", "span", "backward_span", "recorded", "dropped", "clear", "Tracer",
           "StepTimer", "MAX_SPANS"]

MAX_SPANS = 100_000
# the sync debug mode's warning: "called a synchronizing CUDA operation"
_SYNC_WARNING = "synchronizing CUDA operation"

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()  # what a span site enters while the tracer is off


class _Session:
    """One recording: the clock anchor, and the sync debug mode and warning
    handling set for it, put back by `close`."""

    def __init__(self, tracer: "Tracer"):
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.tracer, self.anchor, self.anchor_ns = tracer, None, 0
        self.hooks: list = []  # (backward span, its grad-hook handles)
        if not self.cuda:
            return
        torch.cuda.synchronize()
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record()
        self.anchor_ns = time.time_ns()
        self.mode = torch.cuda.get_sync_debug_mode()
        warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
        self.filter = warnings.filters[0]
        self.shown = warnings.showwarning
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            self.tracer._charge_sync()
        else:
            self.shown(message, category, filename, lineno, file, line)

    def event(self) -> Optional[torch.cuda.Event]:
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def device_ns(self, ev: torch.cuda.Event) -> int:
        return self.anchor_ns + round(self.anchor.elapsed_time(ev) * 1e6)

    def prune(self, everything: bool = False) -> None:
        """Removes the grad hooks of closed backward spans (of all, with
        `everything`): a hook that removes itself while autograd runs it is
        not safe, so they go at the next registration or at the end."""
        keep = []
        for sp, handles in self.hooks:
            if everything or sp.t1 is not None:
                for h in handles:
                    h.remove()
            else:
                keep.append((sp, handles))
        self.hooks = keep

    def close(self) -> None:
        self.prune(everything=True)
        if not self.cuda:
            return
        torch.cuda.set_sync_debug_mode(self.mode)
        if warnings.showwarning == self._show:
            warnings.showwarning = self.shown
        with contextlib.suppress(ValueError):
            warnings.filters.remove(self.filter)
        warnings._filters_mutated()


class _Span:
    """One span; `Tracer.recorded` turns it into a dict."""

    __slots__ = ("tracer", "session", "name", "attrs", "id", "parent", "tid", "step",
                 "request", "t0", "t1", "ev0", "ev1", "dev0", "dev1", "syncs", "rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.t0 = self.t1 = self.ev0 = self.ev1 = self.dev0 = self.dev1 = None
        self.syncs = 0

    def start(self, parent: Optional["_Span"]) -> None:
        tr = self.tracer
        self.session = tr._session
        self.id = next(tr._ids)
        self.parent = None if parent is None else parent.id
        self.step = self.attrs.pop("step", None if parent is None else parent.step)
        self.request = self.attrs.pop("request", None if parent is None else parent.request)
        self.tid = threading.get_ident()
        self.t0 = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = self.session.event()

    def stop(self) -> None:
        self.ev1 = self.session.event()
        self.rf.__exit__(None, None, None)
        self.t1 = time.time_ns()
        self.tracer._keep(self)

    def __enter__(self):
        tr = self.tracer
        if tr._session is None:
            tr._session = _Session(tr)
        stack = tr._stacks.setdefault(threading.get_ident(), [])
        self.start(stack[-1] if stack else None)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = self.tracer._stacks[self.tid]
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        self.stop()
        return False

    def resolve(self) -> None:
        if self.ev0 is not None:
            self.dev0 = self.session.device_ns(self.ev0)
            self.dev1 = self.session.device_ns(self.ev1)
            self.ev0 = self.ev1 = None

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "tid": self.tid,
                "step": self.step, "request": self.request, "host": (self.t0, self.t1),
                "device": None if self.dev0 is None else (self.dev0, self.dev1),
                "syncs": self.syncs, "attrs": dict(self.attrs)}


class Tracer:
    """The spans of one process (the module's functions use one instance)."""

    def __init__(self):
        self._session: Optional[_Session] = None
        self._spans: List[_Span] = []
        self._dropped = 0
        self._stacks: Dict[int, List[_Span]] = {}
        self._ids = itertools.count()

    def span(self, name: str, **attrs):
        """A context manager timing `name`; `step=` or `request=` names the
        unit of work, other attributes are kept with it."""
        if not _enabled():
            if self._session is not None:
                self._close()
            return _NULL
        return _Span(self, name, attrs)

    def backward_span(self, name: str, outputs, inputs) -> None:
        """While recording and under grad mode: times `name` in the backward,
        from the first gradient that reaches any tensor of `outputs` to the
        last of those of `inputs` (a tensor, None, or a dict of them, nested
        dicts included). Only inputs computed by autograd close it: autograd cannot say
        ahead whether `autograd.grad` will reach a leaf, so a parameter is
        timed through the activation it feeds (the frozen tower's layer
        weights through their softmax)."""
        if not _enabled() or not torch.is_grad_enabled():
            return
        outs = [t for t in _tensors(outputs) if t.requires_grad]
        ins = [t for t in _tensors(inputs) if t.grad_fn is not None]
        if not outs or not ins:
            return
        if self._session is None:
            self._session = _Session(self)
        self._session.prune()
        owner = self._stacks.setdefault(threading.get_ident(), [])
        sp = _Span(self, name, {})

        def opened(grad):
            if sp.t0 is None:
                sp.start(owner[-1] if owner else None)

        def closed(grads):
            if sp.t0 is not None and sp.t1 is None:
                sp.stop()

        self._session.hooks.append((sp, (
            torch.autograd.graph.register_multi_grad_hook(outs, opened, mode="any"),
            torch.autograd.graph.register_multi_grad_hook(ins, closed, mode="all"))))

    def recorded(self) -> List[Dict]:
        """The spans kept so far, each a dict: `name`, `id`, `parent`, `tid`,
        `step`, `request`, `host` and `device` (start, end) in ns of
        `time.time_ns` (`device` None without a card), `syncs`, `attrs`.
        Resolves the device edges (a synchronise); clears nothing."""
        self._settle()
        todo = [s for s in self._spans if s.ev0 is not None]
        if todo:
            torch.cuda.synchronize()
            for s in todo:
                s.resolve()
        return [s.as_dict() for s in self._spans]

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        self._spans, self._dropped = [], 0

    def _settle(self) -> None:
        """Ends the recording session once no profiler records (a span site
        does it too): the sync debug mode and warnings are put back."""
        if self._session is not None and not _enabled():
            self._close()

    def _close(self) -> None:
        session, self._session = self._session, None
        session.close()

    def _keep(self, sp: _Span) -> None:
        if len(self._spans) < MAX_SPANS:
            self._spans.append(sp)
        else:
            self._dropped += 1

    def _charge_sync(self) -> None:
        stack = self._stacks.get(threading.get_ident())
        if stack:
            stack[-1].syncs += 1


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


_TRACER = Tracer()
span = _TRACER.span
backward_span = _TRACER.backward_span
recorded = _TRACER.recorded
dropped = _TRACER.dropped
clear = _TRACER.clear


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: `with trace("traces"): step(...)` writes
    `<log_dir>/trace_<pid>_<n>.json`; the CUDA activity is recorded when a
    card is present, and the spans inside are kept (`recorded()`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    _TRACER._settle()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


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
