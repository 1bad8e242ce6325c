"""CUDA kernels the profiler saw per traced batch (stage + ingest of
one replay batch)."""


def read(run):
    ctx = run.ctx
    if ctx.trace is None or not ctx.traced:
        return None
    return len(ctx.trace.kernels) / len(ctx.traced)
