"""Share of the traced window with no kernel, copy or memset on the
card (profiler timeline), %. Copies count as busy: a change that moves
a copy onto a faster path (pinned host memory) shortens the busy time
and the window together, and can raise this share while records_per_s
rises; kernel_idle_pct leaves copies out."""


def read(run):
    ctx = run.ctx
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
