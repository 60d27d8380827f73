"""The gated attention kernel's share of its roofline in a WavLM training
step: the least time of the tower's gated K1 calls' attention kernel (K1b
with the shared (H, T, T) bias and the per-row gate, the one attention
kernel of the step instantiated with a bias at a head of 64) over the
device time of that kernel. One call a tower layer, held to K1's launch
counter (the tower's layers and the branch's one block); each call's
operations and bytes from `lib/roofline_relpos.py`."""
from port_bench.lib.flops import conv_out_len
from port_bench.lib.roofline import least_s, peak
from port_bench.lib.roofline_relpos import k1_gated_attention


def gated_seconds(tl) -> float:
    """Device seconds of `attention_kernel<float, TO, 64, true, ...>`."""
    return sum(sec for name, sec in tl.by_name().items()
               if "attention_kernel<" in name and ", 64, true" in name)


def read(ctx):
    tl, steps, pk = ctx["timeline"], ctx["trace_steps"], peak(ctx["device_name"])
    a = ctx["model_cfg"].audio
    if tl is None or not steps or pk is None or not getattr(a, "rel_pos_bias", False):
        return None
    dev_s = gated_seconds(tl) / steps
    if dev_s <= 0:
        return None
    plan = {"k1": a.n_layers + 1}
    seen = ctx["launches_per_step"]
    if any(abs(seen.get(k, 0) - v) > 1e-9 for k, v in plan.items()):
        ctx["say"](f"[{ctx['metric']}] launches {seen} differ from the plan {plan}")
        return None
    b, t = ctx["out"]["batch"], conv_out_len(int(ctx["mix"]["crop"]), a.conv_layers)
    flops, nbytes = k1_gated_attention(b, t, a.d_model, a.n_heads)
    least = least_s(flops, nbytes, pk) * a.n_layers
    ctx["say"](f"[{ctx['metric']}] calls={a.n_layers} b={b} t={t} flops_per_call={flops:.6e} "
               f"bytes_per_call={nbytes:.6e} least_s={least:.6e} device_s={dev_s:.6e}")
    return 100.0 * least / dev_s
