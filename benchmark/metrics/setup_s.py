"""Process start to the first timed call (host clock, s)."""


def read(run):
    ctx = run.ctx
    return ctx.setup_s if ctx.setup_s > 0 else None
