"""The fused sketch update's share of its roofline over the traced
calls (sketch plane on): least time over device time, summed, %."""


def read(run):
    return run.ctx.roofline_pct("sketch_fused", run.check.traced_work(run)["sketch_fused"])
