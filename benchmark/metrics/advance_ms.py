"""Mean host time of a window advance (fold + flush dispatch) in the
window: span `window.advance` (total_us / count over the window), ms."""


def read(run):
    ctx = run.ctx
    return ctx.span_ms("window.advance")
