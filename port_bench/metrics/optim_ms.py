"""Device ms a training step in the optimizer, from the program's spans:
`step.optimizer` (the gradient's global norm, the clip and Adam). The line
gives every span of the step, host and device ms with their self time."""
from port_bench.metrics import _spans as S


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    value = S.per_unit(groups, ("step.optimizer",))
    ctx["say"](f"[{ctx['metric']}] steps={len(groups)} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups)}")
    return value
