"""Mean device time of the pre-reduce (batch_prereduce) in the
window: span `step.prereduce`'s CUDA event pairs, ms."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "step.prereduce")
