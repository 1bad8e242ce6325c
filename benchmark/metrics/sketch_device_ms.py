"""Mean device time of the sketch plane (sketch_flow_rows) in the
window: span `step.sketch`'s CUDA event pairs, ms."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "step.sketch")
