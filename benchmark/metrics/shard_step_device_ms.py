"""Mean device time of one card's step (pre-reduce, sketch plane,
fanout, counter block, ring append) in the window: span `shard.step`'s
CUDA event pairs, one a card a call, recorded on that card, ms."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "shard.step")
