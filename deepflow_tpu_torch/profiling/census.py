"""Step-cost census — per-callable × bucket-shape attribution (port of
deepflow_tpu/profiling/census.py).

The reference rides XLA: it records a jitted step's abstract argument
shapes when a bucket first dispatches, counts the step's compiles from
the jit cache, walks its jaxpr for `sort` equations and, on the pull
path, asks the compiled module for `cost_analysis()` /
`memory_analysis()`. Eager PyTorch has none of these, so per (service,
step, bucket) the port records:

  * `observe` — the argument shapes and dtypes (a tree of
    `(shape, dtype)` tuples, never the tensors) and a weak reference to
    the step;
  * `note_compile` — the first dispatch of a bucket counts as its one
    "compile": its host wall, taken WITHOUT a device synchronisation
    (one would add a fetch and a copy to the step), is
    `compile_wall_s` / `first_dispatch_s`;
  * `note_sorts` — the logical sorts of that first dispatch, counted by
    ops/segment.sort_census (one `sort_perm` call = one sort): `sorts`
    for the step and `plane_sorts` for the sketch plane's share. They
    depend on the configuration only, so the first dispatch's count is
    cached;
  * `note_outputs` — the output shapes, for the bytes bound.

`snapshot(analyze=True)` adds, from the recorded shapes alone (no step
runs again), `argument_size_in_bytes`, `output_size_in_bytes` and
`bytes_accessed` (their sum — the step's bytes bound). It gives no
`flops`: eager PyTorch counts no operations for sorts and scatters
(`torch.utils.flop_counter` counts matmuls only and would read 0). A
collected step degrades to its shapes, wall time and sorts with an
`analysis_error` note, as in the reference.
"""

from __future__ import annotations

import threading
import weakref


def _abstract(tree):
    """Tree of live args → the same tree with each tensor replaced by
    (shape tuple, dtype name): metadata only, holding no device buffer.
    Dataclasses become dicts of their fields."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_abstract(v) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _abstract(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return tree


def _leaf_bytes(tree) -> int:
    """Σ shape × itemsize over the (shape, dtype) leaves of `_abstract`."""
    import math

    import torch

    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], str):
        return math.prod(tree[0]) * getattr(torch, tree[1]).itemsize
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_leaf_bytes(v) for v in tree)
    return 0


def _ref(fn):
    """Weak reference to a step; a bound method by its WeakMethod."""
    if fn is None:
        return None
    if hasattr(fn, "__self__") and hasattr(fn, "__func__"):
        return weakref.WeakMethod(fn)
    return weakref.ref(fn)


class _Entry:
    __slots__ = ("service", "step", "bucket", "fn_ref", "abstract_args",
                 "abstract_out", "compiles", "compile_wall_s", "first_dispatch_s",
                 "analysis", "analysis_error", "sorts", "plane_sorts")

    def __init__(self, service, step, bucket, fn, abstract_args):
        self.service = service
        self.step = step
        self.bucket = bucket
        self.fn_ref = _ref(fn)
        self.abstract_args = abstract_args
        self.abstract_out = None
        self.compiles = 0
        self.compile_wall_s = 0.0
        self.first_dispatch_s = 0.0
        self.analysis: dict | None = None
        self.analysis_error: str | None = None
        self.sorts: int | None = None
        self.plane_sorts: int | None = None


class StepCostCensus:
    """Per-(service, step, bucket) step cost registry."""

    def __init__(self):
        self._entries: dict[tuple, _Entry] = {}
        self._lock = threading.Lock()

    # -- capture (hot path: host metadata only) --------------------------
    def seen(self, service: str, step: str, bucket: int) -> bool:
        """True when the bucket is recorded AND its callable is still
        alive — a dead ref (the previous same-keyed pipeline was
        collected) reports unseen so the caller re-observes."""
        e = self._entries.get((service, step, int(bucket)))
        return e is not None and (e.fn_ref is None or e.fn_ref() is not None)

    def observe(self, service: str, step: str, bucket: int, fn, args) -> None:
        """Record one bucket the first time it dispatches: the callable
        (weak) + argument shapes and dtypes. Idempotent; no transfer. A
        re-observed dead entry re-points to the live step and recounts
        its sorts (compile counts keep accumulating — a restart's first
        dispatch is real cost)."""
        key = (service, step, int(bucket))
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if e.fn_ref is not None and e.fn_ref() is None:
                    e.fn_ref = _ref(fn)
                    e.abstract_args = _abstract(args)
                    e.abstract_out = None
                    e.analysis = e.analysis_error = None
                    e.sorts = e.plane_sorts = None
                return
            self._entries[key] = _Entry(service, step, int(bucket), fn, _abstract(args))

    def note_compile(self, service: str, step: str, bucket: int, wall_s: float) -> None:
        """Attribute a bucket's first-dispatch host wall (its warmup
        tax) as its compile."""
        with self._lock:
            e = self._entries.get((service, step, int(bucket)))
            if e is None:
                return
            e.compiles += 1
            e.compile_wall_s += float(wall_s)
            if e.first_dispatch_s == 0.0:
                e.first_dispatch_s = float(wall_s)

    def note_sorts(self, service: str, step: str, bucket: int, tally: dict) -> None:
        """Cache the first observed dispatch's sort tally
        (ops/segment.sort_census)."""
        with self._lock:
            e = self._entries.get((service, step, int(bucket)))
            if e is not None and e.sorts is None:
                e.sorts = int(tally["sorts"])
                e.plane_sorts = int(tally["plane_sorts"])

    def note_outputs(self, service: str, step: str, bucket: int, outputs) -> None:
        """Record the first observed dispatch's output shapes."""
        with self._lock:
            e = self._entries.get((service, step, int(bucket)))
            if e is not None and e.abstract_out is None:
                e.abstract_out = _abstract(outputs)

    # -- analysis (pull path; shapes only) --------------------------------
    def _analyze(self, e: _Entry) -> None:
        if e.analysis is not None or e.analysis_error is not None:
            return
        fn = e.fn_ref() if e.fn_ref is not None else None
        if fn is None:
            e.analysis_error = "callable collected"
            return
        arg_b = _leaf_bytes(e.abstract_args)
        out_b = _leaf_bytes(e.abstract_out)
        e.analysis = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
                      "bytes_accessed": float(arg_b + out_b)}

    def snapshot(self, *, analyze: bool = False) -> list[dict]:
        """One JSON-able row per (service, step, bucket). `analyze=True`
        adds the byte sizes of the recorded shapes (cached); nothing runs
        on the device."""
        with self._lock:
            entries = list(self._entries.values())
        rows = []
        for e in sorted(entries, key=lambda e: (e.service, e.step, e.bucket)):
            if analyze:
                self._analyze(e)
            row = {
                "service": e.service,
                "step": e.step,
                "bucket": e.bucket,
                "compiles": e.compiles,
                "compile_wall_s": round(e.compile_wall_s, 4),
                "first_dispatch_s": round(e.first_dispatch_s, 4),
            }
            if e.sorts is not None:
                row["sorts"] = e.sorts
                row["plane_sorts"] = e.plane_sorts
            if e.analysis is not None:
                row.update(e.analysis)
            if e.analysis_error is not None:
                row["analysis_error"] = e.analysis_error
            rows.append(row)
        return rows

    def get_counters(self) -> dict[str, int | float]:
        """Countable face — cheap scalars only: entry and compile counts
        plus the cumulative first-dispatch wall time."""
        with self._lock:
            entries = list(self._entries.values())
        return {
            "entries": len(entries),
            "compiles": sum(e.compiles for e in entries),
            "compile_wall_ms": int(sum(e.compile_wall_s for e in entries) * 1e3),
        }


#: process-wide default census, registered as a Countable so compile
#: pressure dogfoods too
default_census = StepCostCensus()

from ..utils.stats import register_countable  # noqa: E402

register_countable("tpu_step_census", default_census)
