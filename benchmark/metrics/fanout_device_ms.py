"""Mean device time of fanout, doc fingerprint, counter block and ring
append in the window: span `step.fanout`'s CUDA event pairs, ms."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "step.fanout")
