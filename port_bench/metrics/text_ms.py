"""Device ms a step (or batch) in the text tower over the keywords, from the
program's spans: `text` (`encode_keywords` and the cascaded projection) plus
in training `text.bwd` (the gradient into the keywords)."""
from port_bench.metrics import _spans as S

NAMES = ("text", "text.bwd")


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups or not any(s["name"] == "text" for g in groups.values() for s in g):
        return None
    value = S.per_unit(groups, NAMES)
    ctx["say"](f"[{ctx['metric']}] units={len(groups)} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups, NAMES)}")
    return value
