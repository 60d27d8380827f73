"""K3's and K3b's share of their roofline in a training step: one of each at
N = B x slots (CIF's 75, or the K keyword CLS), D the keyword width and V
the token table, held to the program's launch counters; the least time over
the device time of the vq_* kernels."""
from port_bench.lib import roofline as R

PATTERNS = ("vq_fwd_tc_kernel", "vq_reduce_kernel", "vq_combine_kernel", "vq_rows_kernel",
            "vq_cols_kernel", "vq_bwd_tc_kernel", "vq_bwd_fma_kernel", "vq_bwd_reduce_kernel",
            "vq_bwd_dt_kernel")


def read(ctx):
    tl, steps, pk = ctx["timeline"], ctx["trace_steps"], R.peak(ctx["device_name"])
    if tl is None or not steps or pk is None:
        return None
    dev_s = tl.seconds_matching(PATTERNS) / steps
    if dev_s <= 0:
        return None
    c, b = ctx["model_cfg"], ctx["out"]["batch"]
    slots = c.cif.max_feat_len if c.branch_type.endswith("_plus") else c.head.keyword_num
    n, d, v = b * slots, c.head.text_dim, c.clip.vocab_size
    plan = {"k3": 1, "k3b": 1}
    seen = ctx["launches_per_step"]
    if any(abs(seen.get(k, 0) - x) > 1e-9 for k, x in plan.items()):
        ctx["say"](f"[{ctx['metric']}] launches {seen} differ from the plan {plan}")
        return None
    calls = [R.k3(n, d, v), R.k3b(n, d, v)]
    least = sum(R.least_s(f, m, pk) for f, m in calls)
    ctx["say"](f"[{ctx['metric']}] n={n} d={d} v={v} flops_per_step="
               f"{sum(f for f, _ in calls):.6e} bytes_per_step={sum(m for _, m in calls):.6e} "
               f"least_s={least:.6e} device_s={dev_s:.6e}")
    return 100.0 * least / dev_s
