"""How far the host is ahead of the card when a training step returns, in
ms: the median over the traced steps of the device end edge of `fit.step`
less its host end. Near 0, the host waited for the card inside the step.

The line also gives the medians of the step's device interval (`fit.step`'s
edges), of the device period from one step's start edge to the next and of
its host interval, and the coverage: the device ms of `fit.step`, `fit.h2d`
and `fit.log` a step over the traced steps' busy device ms a step (the
timeline's union of kernels, copies and sets)."""
from port_bench.metrics import _spans as S


def lead_ms(groups) -> float:
    return S.median([(S.one(g, "fit.step")["device"][1] - S.one(g, "fit.step")["host"][1])
                     * S.MS for g in groups.values()])


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    value = lead_ms(groups)
    steps = [S.one(g, "fit.step") for g in groups.values()]
    starts = [s["device"][0] for s in steps]
    period = S.median([(b - a) * S.MS for a, b in zip(starts, starts[1:])])
    covered = S.per_unit(groups, ("fit.step", "fit.h2d", "fit.log"))
    tl, n = ctx["timeline"], ctx.get("trace_steps") or len(groups)
    busy = 1e3 * tl.busy_s() / n
    ctx["say"](f"[{ctx['metric']}] steps={len(groups)} "
               f"leads_ms={[round((s['device'][1] - s['host'][1]) * S.MS, 4) for s in steps]} "
               f"step_device_ms(med)={S.median([S.dev_ms(s) for s in steps]):.4f} "
               f"step_period_device_ms(med)={period:.4f} "
               f"step_host_ms(med)={S.median([S.host_ms(s) for s in steps]):.4f} "
               f"spans_device_ms={covered:.4f} busy_device_ms={busy:.4f} "
               f"coverage_pct={100.0 * covered / busy if busy else 0.0:.2f}")
    return value
