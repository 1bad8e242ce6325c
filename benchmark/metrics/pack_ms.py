"""Mean host time of stage()'s packing in the window: pad, valid
check, stack of the tag lanes (span `stage.pack`), ms."""


def read(run):
    return run.ctx.span_ms("stage.pack")
