"""Synchronising CUDA calls a training step inside `fit.step`, counted by
the program while it records (torch's sync debug mode, each call charged to
the innermost span open on its thread; autograd's thread hands its calls to
the thread that runs the backward). The line gives them by span, and those
of the spans around the step (`fit.h2d`, `fit.log`, `fit.sync`), and the
count of every span recorded, by name."""
from port_bench.metrics import _spans as S


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    by_name = S.syncs_by_name(groups)
    outside = {}
    for s in spans:
        if s["name"].startswith("fit.") and s["name"] != "fit.step" and s["syncs"]:
            outside[s["name"]] = outside.get(s["name"], 0) + s["syncs"]
    ctx["say"](f"[{ctx['metric']}] steps={len(groups)} in_step={by_name} "
               f"around_step(total)={outside} spans_recorded={S.counts(spans)}")
    return float(sum(by_name.values()))
