"""Mean host wait on the loader per window step, in ms: `Trainer.timings
["loader_wait_s"]` (the next batch and its copy to the card) over the
window's steps."""


def read(ctx):
    waits = ctx["out"].get("loader_wait_s") or []
    if not waits:
        return None
    ctx["say"](f"[{ctx['metric']}] steps={len(waits)} sum_s={sum(waits):.6f}")
    return 1e3 * sum(waits) / len(waits)
