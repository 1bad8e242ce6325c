"""torch.cuda.max_memory_allocated() after the window and drain, with
the peak reset at set-up start (GiB)."""


def read(run):
    ctx = run.ctx
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
