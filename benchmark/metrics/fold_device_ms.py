"""Mean device time of a fold in the window: span `window.fold`'s
CUDA event pairs, ms."""

from benchmark.span_delta import device_ms


def read(run):
    return device_ms(run.ctx, "window.fold")
