"""Rate of the drain's copy of the other cards' flush rows and blocks
onto card 0 in the window: the bytes span `shard.gather` carried over
its device time on card 0 (its CUDA event pairs: the peer copies are
asynchronous, so the span's host time is their enqueue alone), GB/s."""

from benchmark.span_delta import delta


def read(run):
    nbytes = delta(run.ctx, "shard.gather", "bytes")
    us = delta(run.ctx, "shard.gather", "device_us")
    return nbytes / us / 1e3 if nbytes and us else None
