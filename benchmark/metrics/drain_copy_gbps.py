"""Device-to-host rate of the flush drain's row fetch in the window:
the bytes span `flush.copy` carried over its host time, GB/s."""

from benchmark.span_delta import gbps


def read(run):
    return gbps(run.ctx, "flush.copy")
