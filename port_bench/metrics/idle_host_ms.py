"""Device-idle ms a serving batch spent in host work that could leave the
path between batches: the gaps between consecutive whole requests' device
work (`_spans.work`), each split over the innermost program span open on the
host through it, summed over `serve.pad`, `serve.copy` and `serve.d2h`, over
the number of consecutive pairs. The line gives the whole gap table by span,
`serve.wait` and time outside any program span ('outside') included."""
from port_bench.metrics import _spans as S


def read(ctx):
    spans, groups = S.read(ctx)
    pairs, by_name = S.gaps(spans, groups)
    if not pairs:
        return None
    table = {k: round(v / pairs, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    ctx["say"](f"[{ctx['metric']}] pairs={pairs} idle_ms_per_gap_total="
               f"{sum(by_name.values()) / pairs:.4f} by_span={table}")
    return sum(by_name.get(k, 0.0) for k in S.OFF_PATH) / pairs
