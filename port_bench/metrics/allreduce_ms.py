"""Device ms a training step in NCCL's kernels on rank 0 of a data-parallel
cell: the gradient all-reduce, the gather of the loss features and the
global batch statistics, each kernel's time from its launch on rank 0's
stream to its end (a collective's kernel also waits there for the slowest
rank), from the traced steps' timeline."""

PATTERNS = ("nccl",)


def read(ctx):
    tl, steps = ctx["timeline"], ctx["trace_steps"]
    if tl is None or not steps:
        return None
    names = {n: s for n, s in tl.by_name().items() if any(p in n for p in PATTERNS)}
    if not names:
        return None
    sec = sum(names.values())
    ctx["say"](f"[{ctx['metric']}] device_s={sec:.6f} steps={steps} kernels="
               + " ".join(f"{n[:60]}={s:.6f}" for n, s in sorted(names.items(),
                                                                 key=lambda kv: -kv[1])[:4]))
    return 1e3 * sec / steps
