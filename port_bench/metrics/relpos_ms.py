"""Device ms a training micro-step in WavLM's relative position bias, from
the program's spans: `tower.relpos` (the (H, T, T) gather, once a forward)
plus every `tower.gate` (a layer's gate from its input, inside its
`tower.layer`). None where the program records neither (a HuBERT tower, or
a tree before these spans)."""
from port_bench.metrics import _spans as S

NAMES = ("tower.relpos", "tower.gate")


def read(ctx):
    spans, groups = S.read(ctx)
    if not any(s["name"] in NAMES for g in groups.values() for s in g):
        return None
    value = S.per_unit(groups, NAMES)
    ctx["say"](f"[{ctx['metric']}] units={len(groups)} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups, NAMES)}")
    return value
