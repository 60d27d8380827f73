"""Share of the traced batches' span in which the device ran no kernel,
copy or set: 100 * (1 - busy / window), the span from the first device
activity of the traced steps (or batches) to the last. The traced batches
run after the window, and the profiler's host cost falls on them: the
`[overhead]` line gives their pace beside the untraced window's."""


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.window_s() <= 0:
        return None
    busy, window = tl.busy_s(), tl.window_s()
    ctx["say"](f"[{ctx['metric']}] busy_s={busy:.6f} window_s={window:.6f}")
    return 100.0 * (1.0 - busy / window)
