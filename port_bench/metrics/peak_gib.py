"""Peak device memory the allocator held in the window, in GiB:
`max_memory_allocated` after `reset_peak_memory_stats` at the window's start."""


def read(ctx):
    peak = ctx["out"].get("peak_window_bytes")
    if not peak:
        return None
    ctx["say"](f"[{ctx['metric']}] bytes={peak}")
    return peak / 2 ** 30
