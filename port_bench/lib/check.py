"""The numbers `correct` compares, each against a limit of its own.

Training (the first three steps the set-up drove through the timed call):
  loss_gap   the widest relative gap of a step's loss from the reference's;
  grad_gap   over the trainable leaves, the widest gap between the norm of
             the program's first gradient (Adam's first moment after one
             step over (1 - beta1)) and the reference's, over the larger of
             that leaf's reference norm and the median leaf's;
  step_gap   the same for the norm of each leaf's change over the three
             steps, over the leaves whose reference gradient is at least a
             thousandth of the median leaf's (the others move by round-off
             alone under Adam).
Serving (a seeded sample of the window's batches, every top-k answer):
  score_gap  the widest gap between a returned score and the reference's
             cosine of the same query and image;
  rank_gap   the widest gap by which the reference's cosine of a returned
             image lies below the reference's own score at that rank.
Keyword codes: where the timed path chose keyword codes (a cascaded feature,
in training or serving), the reference takes the program's codes, as a
served model's tokens are judged, and
  kw_gap     the widest gap by which a chosen code's cosine lies below the
             reference's best
judges them; the other numbers then compare the arithmetic over the same
keywords. A cell's limits file names every number its runs compute, with
null for one that is read but not compared.
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

__all__ = ["train_numbers", "query_gaps", "search_numbers", "worst_leaves", "judge"]


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    floor = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {'loss': [..], 'grad': {name: tensor}, 'delta': {name: tensor}};
    ref also 'raw_grad' (the unclipped step-1 gradient, for the leaf rule)
    and, where it took the program's codes, 'kw_gap'."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    g_ref, g_prog = _norms(ref["grad"]), _norms({n: prog["grad"][n] for n in names})
    raw = _norms(ref["raw_grad"])
    med = statistics.median(raw.values())
    live = [n for n in names if raw[n] >= 1e-3 * med]
    d_ref = _norms({n: ref["delta"][n] for n in live})
    d_prog = _norms({n: prog["delta"][n] for n in live})
    out = {"loss_gap": loss_gap, "grad_gap": max(_gaps(g_prog, g_ref, names)),
           "step_gap": max(_gaps(d_prog, d_ref, live))}
    if "kw_gap" in ref:
        out["kw_gap"] = ref["kw_gap"]
    return out


def query_gaps(ref_scores: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor):
    """Each query's widest score and rank gaps (Q,), (Q,): ref_scores (Q, N)
    the reference's cosines, ids and scores (Q, k) the answers."""
    at = ref_scores.gather(1, ids.long())
    top = torch.topk(ref_scores, ids.shape[1], dim=-1).values
    return (scores.float() - at).abs().amax(dim=1), (top - at).clamp_min(0).amax(dim=1)


def search_numbers(per_batch, kw_gap=None) -> Dict[str, float]:
    """The serving numbers over the (score, rank) gaps of every checked
    query, and `kw_gap` where the reference took the program's codes."""
    out = {"score_gap": float(torch.cat([s for s, _ in per_batch]).max()),
           "rank_gap": float(torch.cat([r for _, r in per_batch]).max())}
    if kw_gap is not None:
        out["kw_gap"] = float(kw_gap)
    return out


def worst_leaves(prog, ref):
    """The leaves each training number's worst gaps are at, with their norms."""
    out = {}
    for key in ("grad", "delta"):
        rows = []
        for n in ref[key]:
            a, b = float(prog[key][n].double().norm()), float(ref[key][n].double().norm())
            rows.append((abs(a - b) / max(b, 1e-30), n, a, b))
        out[key] = sorted(rows, reverse=True)[:4]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over every number computed and
    every limit named: each number within its limit. A limit of null names a
    number that is read and printed but not compared (no control separates
    it from sound runs); a number the limits do not name, or a limit without
    a number, is not correct."""
    table = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in list(limits) + [k for k in numbers if k not in limits]}
    ok = all(v["value"] is not None and v["value"] == v["value"] and
             (v["value"] <= v["limit"] if v["limit"] is not None else k in limits)
             for k, v in table.items())
    return ok, table
