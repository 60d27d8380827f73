"""Device ms a step (or batch) in the acoustic tower, from the program's
spans: the `tower` span from its start edge to its end edge, plus in training
`tower.bwd` (the weighted sum's backward into its layer weights, less any
backward span opened inside it). The line gives the tower's spans, host and
device ms with their self time: the frontend's layer 0 (conv 0, its norm and
GELU), the other convolutions (the frontend's self time), the pre-net, the
layers and the weighted sum."""
from port_bench.metrics import _spans as S

NAMES = ("tower", "tower.bwd")
PARTS = ("tower", "tower.frontend", "tower.frontend.layer0", "tower.prenet", "tower.layer",
         "tower.wsum", "tower.bwd")


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    value = S.per_unit(groups, NAMES)
    ctx["say"](f"[{ctx['metric']}] units={len(groups)} dropped={S.dropped()} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups, PARTS)}")
    return value
