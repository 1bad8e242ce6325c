"""Share of the flush drain's row fetches in the window that landed in
page-locked host memory: span `flush.copy`'s `pinned` count over its
count, %. A program that reports no `pinned` count (an older program,
or a CPU device, where nothing is pinned) reads nothing."""

from benchmark.span_delta import delta


def read(run):
    pinned, n = delta(run.ctx, "flush.copy", "pinned"), delta(run.ctx, "flush.copy", "count")
    return 100.0 * pinned / n if pinned is not None and n else None
