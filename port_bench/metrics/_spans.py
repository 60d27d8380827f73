"""The program's own spans (`speechclip_plus_tpu_torch.utils.profiling`),
reduced to the numbers of the per-layer metrics that read them. Not a
reader: the family readers beside it (`tower_ms.py`, `idle_host_ms.py`, ...)
import it.

The program records its spans while a profiler records, so in a traced run
they cover the traced steps (or batches). Each span is a dict with `name`,
`id`, `parent`, `tid`, `step`, `request`, `host` and `device` (start, end) in
ns of `time.time_ns`, the Chrome trace's clock (`device` from CUDA events on
the stream, None without a card), and `syncs` (synchronising CUDA calls made
while it was its thread's innermost span). A unit is a training micro-step
whose `fit.step` span was recorded whole, or a serving request whose
`serve.submit` and `serve.d2h` spans were; every number is a sum over units
divided by their count.

A device edge marks when the stream reached the event: on a busy stream the
end of the work queued before it, on an idle one the moment the host recorded
it. The backward spans (`*.bwd`) run on autograd's thread and overlap: each
device instant of a backward span is charged to the latest-opened backward
span covering it, so a module's backward excludes those opened inside it (the
text tower's backward inside the branch's).
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MS = 1e-6  # ns -> ms
BACKWARD = ("tower.bwd", "branch.bwd", "text.bwd")
# the host work between two batches that could leave the path
OFF_PATH = ("serve.pad", "serve.copy", "serve.d2h")


def read(ctx) -> Tuple[List[dict], Dict[int, List[dict]]]:
    """(the program's spans, its units for the metric `ctx` names) of a
    traced run on the card; no units off the card, untraced, or where the
    program keeps no spans (a tree before its tracer)."""
    if ctx.get("timeline") is None or ctx.get("device_name", "cpu") == "cpu":
        return [], {}
    try:
        from speechclip_plus_tpu_torch.utils.profiling import recorded
    except ImportError:
        return [], {}
    spans = recorded()
    if not any(s["device"] for s in spans):
        return [], {}
    return spans, units(spans, ctx["metric"])


def counts(spans: Sequence[dict]) -> Dict[str, int]:
    """Spans recorded, by name."""
    out: Dict[str, int] = defaultdict(int)
    for s in spans:
        out[s["name"]] += 1
    return dict(out)


def dropped() -> int:
    """Spans the program dropped past its buffer's bound."""
    from speechclip_plus_tpu_torch.utils.profiling import dropped as count
    return count()


def units(spans: Sequence[dict], metric: str) -> Dict[int, List[dict]]:
    """Unit id -> its spans: the micro-steps of a `*.train` metric, the
    requests of a `*.search` one, kept only where recorded whole."""
    if metric.endswith(".train"):
        return steps(spans)
    return requests(spans)


def _group(spans, key, needed) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = defaultdict(list)
    for s in spans:
        if s[key] is not None:
            out[s[key]].append(s)
    return {u: g for u, g in sorted(out.items())
            if set(needed) <= {s["name"] for s in g}}


def steps(spans) -> Dict[int, List[dict]]:
    return _group(spans, "step", ("fit.step",))


def requests(spans) -> Dict[int, List[dict]]:
    return _group(spans, "request", ("serve.submit", "serve.d2h"))


def one(group: Sequence[dict], name: str) -> dict:
    return next(s for s in group if s["name"] == name)


def _length(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def _clip(iv, others):
    a, b = iv
    return [(max(a, x), min(b, y)) for x, y in others if min(b, y) > max(a, x)]


def _later_backward(s: dict, group: Sequence[dict]) -> List[dict]:
    """For a backward span, the backward spans of its unit opened after it."""
    if s["name"] not in BACKWARD:
        return []
    return [o for o in group if o["name"] in BACKWARD and o["host"][0] > s["host"][0]]


def _inside(s: dict, group: Sequence[dict]) -> List[dict]:
    """The spans whose time counts inside `s` and not as its own: its
    children, and for a backward span the backward spans opened after it."""
    return [c for c in group if c["parent"] == s["id"]] + _later_backward(s, group)


def dev_ms(s: dict, group: Sequence[dict] = ()) -> float:
    """Device ms of a span, from its start edge to its end edge; a backward
    span less the backward spans opened inside it (`group`: its unit)."""
    if s["device"] is None:
        return 0.0
    later = [o["device"] for o in _later_backward(s, group) if o["device"]]
    return (s["device"][1] - s["device"][0] - _length(_clip(s["device"], later))) * MS


def host_ms(s: dict) -> float:
    return (s["host"][1] - s["host"][0]) * MS


def self_ms(s: dict, group: Sequence[dict], clock: str) -> float:
    """A span's duration on `clock` ("host" or "device") less the part
    covered by the spans inside it."""
    iv = s[clock]
    if iv is None:
        return 0.0
    inner = [o[clock] for o in _inside(s, group) if o[clock] is not None]
    return (iv[1] - iv[0] - _length(_clip(iv, inner))) * MS


def per_unit(groups: Dict[int, List[dict]], names: Sequence[str]) -> float:
    """Device ms a unit in the spans named `names` (a backward span less
    those opened inside it)."""
    total = sum(dev_ms(s, g) for g in groups.values() for s in g if s["name"] in names)
    return total / len(groups)


def table(groups: Dict[int, List[dict]], names: Optional[Sequence[str]] = None) -> str:
    """'name=host_ms/self,device_ms/self(count)' a unit, for every span name
    (or `names`) of the units, in the order first opened."""
    rows: Dict[str, List[float]] = {}
    for g in groups.values():
        for s in sorted(g, key=lambda s: (s["host"][0], s["id"])):
            if names is not None and s["name"] not in names:
                continue
            r = rows.setdefault(s["name"], [0.0, 0.0, 0.0, 0.0, 0])
            r[0] += host_ms(s)
            r[1] += self_ms(s, g, "host")
            r[2] += dev_ms(s, g)
            r[3] += self_ms(s, g, "device")
            r[4] += 1
    n = len(groups)
    return " ".join(f"{k}={r[0] / n:.4f}/{r[1] / n:.4f},{r[2] / n:.4f}/{r[3] / n:.4f}"
                    f"({r[4] / n:g})" for k, r in rows.items())


def descendants(group: Sequence[dict], root: dict) -> List[dict]:
    """`root` and every span under it in its unit."""
    kids = defaultdict(list)
    for s in group:
        kids[s["parent"]].append(s)
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo += kids[s["id"]]
    return out


def syncs_by_name(groups: Dict[int, List[dict]], root: str = "fit.step") -> Dict[str, float]:
    """Synchronising calls a unit under `root`, by span name."""
    out: Dict[str, float] = defaultdict(float)
    for g in groups.values():
        for s in descendants(g, one(g, root)):
            if s["syncs"]:
                out[s["name"]] += s["syncs"] / len(groups)
    return dict(out)


def median(xs: Sequence[float]) -> float:
    return statistics.median(xs) if xs else 0.0


def work(group: Sequence[dict]) -> Tuple[int, int]:
    """A request's device work: from where its H2D copy is issued (the host
    end of `serve.copy`) or its first kernel (the start edge of
    `serve.encode`), whichever is first, to the end edge of `serve.submit`
    (its top-k). The edges of `serve.wait` and `serve.d2h` sit behind the
    next request's work on the stream, so they are left out."""
    copy, enc, sub = one(group, "serve.copy"), one(group, "serve.encode"), \
        one(group, "serve.submit")
    return min(copy["host"][1], enc["device"][0]), sub["device"][1]


def innermost(spans: Sequence[dict], a: int, b: int) -> Dict[str, int]:
    """ns of [a, b) by the innermost span open on the host, 'outside' where
    none is."""
    cuts = sorted({a, b} | {t for s in spans for t in s["host"] if a < t < b})
    out: Dict[str, int] = defaultdict(int)
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) / 2
        open_ = [s for s in spans if s["host"][0] <= mid < s["host"][1]]
        # the latest opened; of two opened at once the later id, the child
        name = max(open_, key=lambda s: (s["host"][0], s["id"]))["name"] if open_ \
            else "outside"
        out[name] += y - x
    return dict(out)


def gaps(spans: Sequence[dict], groups: Dict[int, List[dict]]
         ) -> Tuple[int, Dict[str, float]]:
    """The device's idle gaps between consecutive whole requests' work, each
    split over the innermost program span open on the host through it (the
    thread that submits): (number of consecutive pairs, ms by span name)."""
    ids = sorted(groups)
    if len(ids) < 2:
        return 0, {}
    tid = one(groups[ids[0]], "serve.submit")["tid"]
    host = [s for s in spans if s["tid"] == tid]
    out: Dict[str, float] = defaultdict(float)
    pairs = 0
    for r0, r1 in zip(ids, ids[1:]):
        if r1 != r0 + 1:
            continue
        pairs += 1
        g0, g1 = work(groups[r0])[1], work(groups[r1])[0]
        if g1 > g0:
            for name, ns in innermost(host, g0, g1).items():
                out[name] += ns * MS
    return pairs, dict(out)
