"""Mean device time of the window-close sketch merge across cards in
the window (window_close: each card's ring folded, the max and sums
gathered onto card 0 and handed back): span `shard.merge`'s CUDA event
pairs on card 0, ms. The span's host-only records (the host merge of the
closed blocks) carry no pair."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "shard.merge")
