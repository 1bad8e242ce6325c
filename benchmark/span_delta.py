"""Window deltas of the program's span summaries (`tracer.summary()`,
taken by the harness at the window's start and close) for the
per-layer readers: a key that the program does not report (an older
program without the span, or a CPU device without device time) reads
None, never zero."""

from __future__ import annotations


def delta(ctx, name: str, key: str):
    """The growth of `key` of span `name` over the window, or None."""
    after = ctx.spans_after.get(name, {})
    if key not in after:
        return None
    return after[key] - ctx.spans_before.get(name, {}).get(key, 0)


def device_ms(ctx, name: str) -> float | None:
    """Mean device time (ms) of the span's resolved CUDA event pairs in
    the window: the stream's time from its first launch to its last
    kernel's end."""
    us, n = delta(ctx, name, "device_us"), delta(ctx, name, "device_count")
    return us / n / 1e3 if n else None


def gbps(ctx, name: str) -> float | None:
    """The span's bytes over its host time in the window, GB/s (1e9 B)."""
    nbytes, us = delta(ctx, name, "bytes"), delta(ctx, name, "total_us")
    return nbytes / us / 1e3 if nbytes and us else None
