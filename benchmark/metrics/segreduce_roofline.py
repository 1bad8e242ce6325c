"""The segmented reduce's share of its roofline over the traced calls:
the sum of each call's least time (the live rows' logical bytes over
the card's memory bandwidth; benchmark/work.py) over the sum of the
kernels' device time, %. The kernel reads only the rows of live
segments, so those are its work."""


def read(run):
    return run.ctx.roofline_pct("segreduce", run.check.traced_work(run)["segreduce"])
