"""Mean host time of the flush drain (fetch and split of the closed
windows) in the window: span `flush.drain` (total_us / count), ms."""


def read(run):
    ctx = run.ctx
    return ctx.span_ms("flush.drain")
