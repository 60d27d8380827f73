"""Device ms a step (or batch) in the branch and its keyword head, from the
program's spans: `branch` (the branch's transformer, CIF, keyword BN and VQ,
or the parallel feature's attention alone) plus in training `branch.bwd`,
less the backward spans opened inside it (the text tower's). The line gives
the branch's spans, host and device ms with their self time."""
from port_bench.metrics import _spans as S

NAMES = ("branch", "branch.bwd")
PARTS = ("branch", "branch.cif", "branch.kw_bn", "branch.vq", "branch.bwd")


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    value = S.per_unit(groups, NAMES)
    ctx["say"](f"[{ctx['metric']}] units={len(groups)} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups, PARTS)}")
    return value
