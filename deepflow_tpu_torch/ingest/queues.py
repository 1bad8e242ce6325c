"""Bounded overwrite queues for the ingest plane (port copy of
deepflow_tpu/ingest/queues.py).

Mirrors the reference's `OverwriteQueue` (libs/queue/queue.go:43-260):
fixed capacity, *overwrites oldest on overflow* (backpressure sheds the
oldest data, never blocks the producer), blocking batched `gets` with a
timeout on the consumer side.

Two interchangeable implementations: the C++ ring in
deepflow_tpu_torch/native/src/queue.cc (used when the shared object
builds) and a Python fallback with identical semantics. `new_queue`
picks automatically.
"""

from __future__ import annotations

import collections
import threading

from .. import native


class PyOverwriteQueue:
    """Python twin of native.OverwriteQueue (same API and semantics)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._overwritten = 0
        self._closed = False

    def put(self, item: bytes) -> bool:
        """Enqueue (overwriting oldest on overflow). Returns False when
        the queue is already closed — the item was NOT accepted."""
        with self._cond:
            if self._closed:
                return False
            if len(self._dq) >= self.capacity:
                self._dq.popleft()
                self._overwritten += 1
            self._dq.append(bytes(item))
            self._cond.notify()
            return True

    def gets(self, max_items: int, timeout_ms: int = -1) -> list[bytes]:
        """Block until ≥1 item (or timeout/close); pop up to max_items."""
        timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
        with self._cond:
            if not self._dq and not self._closed:
                self._cond.wait(timeout)
            out = []
            while self._dq and len(out) < max_items:
                out.append(self._dq.popleft())
            return out

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def overwritten(self) -> int:
        with self._lock:
            return self._overwritten

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def get_counters(self) -> dict:
        """Countable face: depth, capacity, overwrites and the closed flag."""
        with self._lock:
            return {"depth": len(self._dq), "capacity": self.capacity,
                    "overwritten": self._overwritten, "closed": int(self._closed)}


def new_queue(capacity: int, prefer_native: bool = True):
    """OverwriteQueue factory: native C++ ring when built, else Python."""
    if prefer_native and native.native_available():
        return native.OverwriteQueue(capacity)
    return PyOverwriteQueue(capacity)


def register_queue_stats(module: str, queues, **tags: str):
    """Register every queue on the default StatsCollector, one source
    per queue (tagged with its index), so overwrite drops are visible
    the moment the queue exists. Queues are weakly held. Returns the
    CounterSource list (callers may deregister explicitly)."""
    from ..utils.stats import register_countable

    return [
        register_countable(module, q, queue=str(i), **tags)
        for i, q in enumerate(queues)
    ]
