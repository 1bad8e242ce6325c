"""Reduce a torch.profiler trace of the traced batches to the numbers
the per-layer readers and the result's `breakdown` use.

The traced window is the benchmark's own `bench.window` range. Device
activity is every kernel, copy and memset the profiler saw on the card;
busy time is their union inside the window, kernel busy time the union
of the kernels alone. An idle gap is a stretch of
the window with nothing on the card, named by the innermost host range
open at its middle (a benchmark range or an aten operator).
"""

from __future__ import annotations

import dataclasses

WINDOW_RANGE = "bench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_busy_s: float
    kernels: list  # (name, start_us, end_us) of kernel launches, by start
    device_ops: list  # [[name, seconds]] top by total time
    idle_gaps: list  # [[host activity, seconds]] longest first

    def kernel_durations(self, patterns) -> list[float]:
        """Durations (s) of the kernels whose names hold any of
        `patterns`, in launch order."""
        return [(e - s) * 1e-6 for n, s, e in self.kernels
                if any(p in n for p in patterns)]


def _kind(evt) -> str:
    """"device" for a kernel, copy or memset on the card, "host" for a
    host range or operator, "" for the card-side mirror of a host
    `record_function` range (a user annotation), which is no work."""
    on_card = getattr(evt.device_type, "name", str(evt.device_type)).upper() == "CUDA"
    if not on_card:
        return "host"
    if getattr(evt, "is_user_annotation", False) or evt.name.startswith("bench."):
        return ""
    return "device"


def summarize(events, top: int = 10) -> TraceSummary | None:
    """None when the trace holds no window range or no device activity."""
    kinds = [(e, _kind(e)) for e in events]
    win = [e for e, k in kinds if k == "host" and e.name == WINDOW_RANGE]
    if not win:
        return None
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    dev, host = [], []
    for e, k in kinds:
        s, t = e.time_range.start, e.time_range.end
        if not k or t <= w0 or s >= w1:
            continue
        (dev if k == "device" else host).append((e.name, max(s, w0), min(t, w1)))
    if not dev:
        return None
    dev.sort(key=lambda x: x[1])
    busy, gaps = _union(dev, w0, w1)
    kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
    kernel_busy, _ = _union(kernels, w0, w1)
    totals: dict[str, float] = {}
    for n, s, t in dev:
        totals[n] = totals.get(n, 0.0) + (t - s)
    device_ops = [[n, v * 1e-6] for n, v in sorted(totals.items(), key=lambda x: -x[1])[:top]]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "(no host range)"
        idle.append([name, (b - a) * 1e-6])
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        kernel_busy_s=kernel_busy * 1e-6, kernels=kernels,
                        device_ops=device_ops, idle_gaps=idle)


def _union(spans, w0, w1):
    """(length of the union of (name, start, end) spans sorted by start,
    the gaps between them inside [w0, w1])."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((w0 if cur_e is None else cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is None:
        return 0.0, [(w0, w1)]
    busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    return busy, gaps
