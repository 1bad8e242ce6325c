"""Share of the traced window in which no kernel ran on the card
(profiler timeline; copies and memsets are not kernels), %."""


def read(run):
    ctx = run.ctx
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.kernel_busy_s / ctx.trace.window_s)
