"""Mean host time of the counter-block fetch in the window: span
`stats.fetch` (total_us / count over the window), ms."""


def read(run):
    ctx = run.ctx
    return ctx.span_ms("stats.fetch")
