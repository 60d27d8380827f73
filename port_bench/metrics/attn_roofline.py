"""Attention kernels' share of their roofline in a training step: the least
time of the step's K1 (with K1a's projections), K1b and K2 calls over the
device time of their kernels. The calls are planned from the cell's shapes
(the tower's fused-out block per layer, the branch's context-only block and
its backward) and held to the program's launch counters; each call's least
time is the larger of its operations over the bf16 peak and its bytes over
the memory bandwidth."""
from port_bench.lib import roofline as R
from port_bench.lib.flops import branch_sequence, conv_out_len

PATTERNS = ("projection_wgmma_kernel", "attention_kernel", "attention_wide_kernel",
            "attention_bwd_kernel", "attention_bwd_wide_kernel", "bwd_dvec_kernel")


def read(ctx):
    tl, steps, pk = ctx["timeline"], ctx["trace_steps"], R.peak(ctx["device_name"])
    if tl is None or not steps or pk is None:
        return None
    dev_s = tl.seconds_matching(PATTERNS) / steps
    if dev_s <= 0:
        return None
    c, b = ctx["model_cfg"], ctx["out"]["batch"]
    frames = conv_out_len(int(ctx["mix"]["crop"]), c.audio.conv_layers)
    tb, ta = branch_sequence(c, frames), c.cascaded_ta
    calls = [(R.k1_fused_out(b, frames, c.audio.d_model, c.audio.n_heads), c.audio.n_layers),
             (R.k1_context(b, tb, ta.d_model, ta.nhead), 1),
             (R.k2(b, tb, ta.d_model, ta.nhead), 1)]
    plan = {"k1": c.audio.n_layers + 1, "k2": 1}
    seen = ctx["launches_per_step"]
    if any(abs(seen.get(k, 0) - v) > 1e-9 for k, v in plan.items()):
        ctx["say"](f"[{ctx['metric']}] launches {seen} differ from the plan {plan}")
        return None
    flops = sum(f * n for (f, _), n in calls)
    nbytes = sum(m * n for (_, m), n in calls)
    least = sum(R.least_s(f, m, pk) * n for (f, m), n in calls)
    ctx["say"](f"[{ctx['metric']}] flops_per_step={flops:.6e} bytes_per_step={nbytes:.6e} "
               f"least_s={least:.6e} device_s={dev_s:.6e}")
    return 100.0 * least / dev_s
