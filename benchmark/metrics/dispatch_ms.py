"""Mean host time of the append step's dispatch in the window: span
`ingest.dispatch` (total_us / count over the window), ms."""


def read(run):
    ctx = run.ctx
    return ctx.span_ms("ingest.dispatch")
