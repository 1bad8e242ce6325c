"""Batched table writer — the ckwriter analog.
Port copy of deepflow_tpu/storage/writer.py.

`CKWriter.Put` queues rows, a per-queue goroutine batches them and flushes
on size or timeout, with retry and connection reset on failure
(server/ingester/pkg/ckwriter/ckwriter.go:481-636). `TableWriter` keeps
that contract against the columnar store: `put(cols)` enqueues a column
batch; the flusher thread coalesces batches and inserts one part per
flush, retrying on transient store errors; counters surface
write-ok/fail/retry like ckwriter's Countable (ckwriter.go:465-479).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from .. import chaos
from ..utils.stats import register_countable
from .store import ColumnarStore, TableSchema


class _WriterLiveSource:
    """LiveRegistry provider over a TableWriter's queued-but-unflushed
    batches: the server-layer
    metrics writers' pending rows ARE the open span for their tables —
    a range query ending "now" sees rows the flusher has not landed
    yet, marked partial, and the flushed insert supersedes them (the
    mirror drops a batch BEFORE its insert, so a row is never served
    from both sides — transient invisibility between drop and insert
    is a bounded freshness gap, never a double count)."""

    def __init__(self, writer: "TableWriter"):
        self._writer = writer

    def __call__(self, lo: int, hi: int):
        w = self._writer
        with w._lock:
            pending = list(w._live_pending)
        if not pending:
            return None
        names = w.schema.column_names()
        tcol = w.schema.time_column
        parts = []
        for b in pending:
            try:
                ts = np.asarray(b[tcol], np.int64)
            except (KeyError, TypeError):
                continue
            sel = (ts >= lo) & (ts < hi)
            if sel.any():
                try:
                    parts.append({k: np.asarray(b[k])[sel] for k in names})
                except KeyError:  # malformed batch — the flusher counts it
                    continue
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in names}

    def epoch(self) -> int:
        return self._writer._live_epoch

    def open_from(self) -> int | None:
        w = self._writer
        tcol = w.schema.time_column
        with w._lock:
            pending = list(w._live_pending)
        vals = [
            int(np.min(b[tcol])) for b in pending
            if tcol in b and len(np.atleast_1d(b[tcol]))
        ]
        return min(vals) if vals else None


class TableWriter:
    def __init__(
        self,
        store: ColumnarStore,
        db: str,
        schema: TableSchema,
        *,
        batch_size: int = 1 << 15,
        flush_interval_s: float = 1.0,
        queue_capacity: int = 256,
        retries: int = 3,
        live_registry=None,
    ):
        store.create_table(db, schema)
        self.store = store
        self.db = db
        self.schema = schema
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.retries = retries
        self._q: queue.Queue = queue.Queue(maxsize=queue_capacity)
        self.counters = {
            "write_ok": 0,
            "write_fail": 0,
            "retry": 0,
            "dropped_full": 0,
            "pending_rows": 0,
        }
        self._lock = threading.Lock()
        # live read plane: the pending mirror tracks batches
        # from put() until the flusher hands them to the store; a
        # registered _WriterLiveSource serves them as open-span rows
        self._live_pending: list = []
        self._live_epoch = 0
        self._live_handle = None
        self._live_registry = live_registry
        if live_registry is not None:
            self._live_handle = live_registry.register(
                db, schema.name, _WriterLiveSource(self)
            )
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        # register the writer itself (weakly held → auto-deregistered);
        # stop() also deregisters explicitly for deterministic teardown
        self._stats_src = register_countable(
            "table_writer", self, db=db, table=schema.name
        )

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    # -- producer side --------------------------------------------------
    def put(self, cols: dict[str, np.ndarray]) -> bool:
        """Enqueue a column batch; sheds (and counts) when the queue is
        full — matching the reference's drop-not-block backpressure."""
        n = len(next(iter(cols.values()))) if cols else 0
        if n == 0:
            return True
        # mirror BEFORE the queue handoff: once the batch is in the
        # queue the flusher may retire-and-insert it at any moment, and
        # a mirror append landing after that retire pass would serve
        # the rows live forever ALONGSIDE their store copy (permanent
        # double count + mirror leak)
        if self._live_handle is not None:
            with self._lock:
                self._live_pending.append(cols)
                self._live_epoch += 1
        try:
            self._q.put_nowait(cols)
            with self._lock:
                self.counters["pending_rows"] += n
            return True
        except queue.Full:
            with self._lock:
                self.counters["dropped_full"] += n
                if self._live_handle is not None and self._live_pending:
                    # the batch never entered the pipeline — un-mirror it
                    self._live_pending = [
                        b for b in self._live_pending if b is not cols
                    ]
                    self._live_epoch += 1
            return False

    # -- flusher --------------------------------------------------------
    def _run(self):
        pending: list[dict[str, np.ndarray]] = []
        pending_rows = 0
        deadline = time.monotonic() + self.flush_interval_s
        while True:
            timeout = max(0.0, deadline - time.monotonic())
            try:
                item = self._q.get(timeout=timeout)
                pending.append(item)
                pending_rows += len(next(iter(item.values())))
            except queue.Empty:
                pass
            now = time.monotonic()
            if pending and (pending_rows >= self.batch_size or now >= deadline):
                self._flush(pending, pending_rows)
                pending, pending_rows = [], 0
            if now >= deadline:
                deadline = now + self.flush_interval_s
            if self._stop.is_set() and self._q.empty():
                if pending:
                    self._flush(pending, pending_rows)
                return

    def _flush(self, batches: list[dict[str, np.ndarray]], rows: int):
        names = self.schema.column_names()
        # retire the batches from the live mirror BEFORE the insert:
        # between retire and insert a query sees neither copy (a bounded
        # freshness gap — the rows "haven't arrived yet"); retiring
        # after would let one query see both and double-count in SQL
        # aggregates, the forbidden outcome
        with self._lock:
            if self._live_handle is not None and self._live_pending:
                ids = {id(b) for b in batches}
                self._live_pending = [
                    b for b in self._live_pending if id(b) not in ids
                ]
                self._live_epoch += 1
        try:
            merged = {
                nm: np.concatenate([np.asarray(b[nm]) for b in batches]) for nm in names
            }
            for attempt in range(self.retries):
                try:
                    # chaos seam: storage write faults (SinkWriteError is
                    # an OSError, so injected failures exercise the real
                    # retry/fail-count path below)
                    chaos.maybe_fail(chaos.SITE_SINK_WRITE)
                    self.store.insert(self.db, self.schema.name, merged)
                    with self._lock:
                        self.counters["write_ok"] += rows
                        self.counters["pending_rows"] -= rows
                    return
                except OSError:
                    with self._lock:
                        self.counters["retry"] += 1
                    time.sleep(0.05 * (attempt + 1))
        except Exception:
            # malformed batch (missing/ragged columns) — count it as a
            # failed write; the flusher thread must survive any input
            pass
        with self._lock:
            self.counters["write_fail"] += rows
            self.counters["pending_rows"] -= rows

    def flush(self, timeout: float = 5.0) -> None:
        """Drain everything queued so far (tests / shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.counters["pending_rows"] == 0 and self._q.empty():
                    return
            time.sleep(0.01)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._live_handle is not None:
            self._live_registry.unregister(self._live_handle)
            self._live_handle = None
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)
