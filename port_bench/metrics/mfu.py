"""The whole step's share of the card's dense bf16 peak over the window:
the benchmark's frozen analytic FLOP count of a cached-image step at the
padded length the step computes on, times the window's steps, over the
window's seconds and the peak. The window runs untraced, in the traced run
too (its traced steps come after it)."""
from port_bench.lib.flops import train_step_flops
from port_bench.lib.roofline import peak


def read(ctx):
    pk = peak(ctx["device_name"])
    out = ctx["out"]
    if pk is None or not out.get("steps"):
        return None
    flops = train_step_flops(ctx["model_cfg"], out["batch"], int(ctx["mix"]["crop"]),
                             cached_image=True)["total"]
    ctx["say"](f"[{ctx['metric']}] flops_per_step={flops:.6e} steps={out['steps']} "
               f"window_s={out['window_s']:.6f} peak_flops={pk['bf16']:.6e}")
    return 100.0 * flops * out["steps"] / out["window_s"] / pk["bf16"]
