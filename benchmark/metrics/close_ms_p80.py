"""80th percentile over every window closed in the window of its close
latency: from the start of the stage() call of the batch that closes it
(in an open loop, from the batch's arrival) to the return of the
ingest_staged() that hands its documents to the host (host clock, ms).
At about 55 closed windows a run, p80 is the highest percentile with
ten windows beyond it."""


def read(run):
    return run.ctx.percentile(run.ctx.close_ms, 80)
