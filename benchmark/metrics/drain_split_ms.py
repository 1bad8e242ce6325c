"""Mean host time of the flush drain's host split in the window (rows
into windows, block unpack, sketch-only windows, cascade hand-off):
span `flush.split`, ms."""


def read(run):
    return run.ctx.span_ms("flush.split")
