"""Mean host time of the flush drain's scalar fetch in the window,
which waits for the fold and flush still queued on the card: span
`flush.wait`, ms."""


def read(run):
    return run.ctx.span_ms("flush.wait")
