"""Mean host time of one stage() call in the window: padding, the
stack of the tag lanes and the upload (benchmark clock, ms)."""


def read(run):
    ctx = run.ctx
    return 1e3 * sum(ctx.stage_s) / len(ctx.stage_s) if ctx.stage_s else None
