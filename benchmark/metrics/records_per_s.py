"""Valid flow records handed to stage() in the window, per second of
the window's wall time (host clock)."""


def read(run):
    ctx = run.ctx
    return ctx.records / ctx.window_s if ctx.window_s > 0 else None
