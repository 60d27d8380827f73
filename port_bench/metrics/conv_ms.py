"""Device ms a step (or batch) in the acoustic tower's cuDNN convolution
kernels and the layout transforms cuDNN runs around them, from the traced
steps' timeline."""

PATTERNS = ("convolve", "fprop", "dgrad", "wgrad", "winograd", "conv1d", "conv2d",
            "nchwToNhwc", "nhwcToNchw")


def read(ctx):
    tl, steps = ctx["timeline"], ctx["trace_steps"]
    if tl is None or not steps:
        return None
    sec = tl.seconds_matching(PATTERNS)
    if sec <= 0:
        return None
    ctx["say"](f"[{ctx['metric']}] device_s={sec:.6f} steps={steps}")
    return 1e3 * sec / steps
