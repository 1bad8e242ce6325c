"""SmartEncoding sidecar dictionary writers — the flow_tag analog.
Port copy of deepflow_tpu/storage/flow_tag.py.

The reference writes, alongside every data batch, dictionary rows per
(org, table, field_name, field_value) so string-valued tags stay
integer-encoded in the wide tables and the querier can enumerate /
translate values at query time (server/ingester/flow_tag/flow_tag_writer.go;
app_service_tag_writer.go:92). Both writers cache recently-written keys
and re-emit only after `cache_ttl_s`, matching FlowTagWriter's
cache-with-timeout dedup.

Tables (one per db, with a `table` column rather than per-table clones):
  flow_tag.custom_field        (time, table, field_name)
  flow_tag.custom_field_value  (time, table, field_name, field_value, count)
  flow_tag.app_service         (time, table, app_service, app_instance)
"""

from __future__ import annotations

import threading

import numpy as np

from .store import ColumnarStore, ColumnSpec, TableSchema
from .writer import TableWriter

FIELD_SCHEMA = TableSchema(
    "custom_field",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("table", "U64"),
        ColumnSpec("field_name", "U128"),
    ),
    partition_s=86400,
)

FIELD_VALUE_SCHEMA = TableSchema(
    "custom_field_value",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("table", "U64"),
        ColumnSpec("field_name", "U128"),
        ColumnSpec("field_value", "U256"),
        ColumnSpec("count", "u8"),
    ),
    partition_s=86400,
)

APP_SERVICE_SCHEMA = TableSchema(
    "app_service",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("table", "U64"),
        ColumnSpec("app_service", "U256"),
        ColumnSpec("app_instance", "U256"),
    ),
    partition_s=86400,
)


class _CachedDictWriter:
    def __init__(self, writer: TableWriter, cache_ttl_s: float):
        self.writer = writer
        self.cache_ttl_s = cache_ttl_s
        self._cache: dict[tuple, float] = {}
        self._lock = threading.Lock()
        self.cache_hits = 0

    def emit(self, now: float, keys: list[tuple], rows_fn) -> int:
        """Write rows for keys not seen within the TTL; returns written."""
        fresh = []
        with self._lock:
            # prune expired entries so high-cardinality values (endpoints,
            # per-pod instances) don't grow the cache without bound
            if len(self._cache) > 1 << 20:
                self._cache = {
                    k: t for k, t in self._cache.items() if now - t < self.cache_ttl_s
                }
            for k in keys:
                last = self._cache.get(k)
                if last is not None and now - last < self.cache_ttl_s:
                    self.cache_hits += 1
                    continue
                self._cache[k] = now
                fresh.append(k)
        if fresh:
            self.writer.put(rows_fn(fresh))
        return len(fresh)


class FlowTagWriter:
    """Custom-field dictionary sidecar (flow_tag_writer.go analog)."""

    def __init__(
        self, store: ColumnarStore, db: str = "flow_tag", cache_ttl_s: float = 600.0
    ):
        self._fields = _CachedDictWriter(
            TableWriter(store, db, FIELD_SCHEMA, flush_interval_s=0.2), cache_ttl_s
        )
        self._values = _CachedDictWriter(
            TableWriter(store, db, FIELD_VALUE_SCHEMA, flush_interval_s=0.2), cache_ttl_s
        )

    def write(
        self,
        now: int,
        table: str,
        fields: dict[str, dict[str, int]],
    ) -> None:
        """fields: field_name → {field_value: count}. Value counts are
        summed per flush batch; the cache only gates re-emission."""
        self._fields.emit(
            now,
            [(table, f) for f in fields],
            lambda fresh: {
                "time": np.full(len(fresh), now, np.uint32),
                "table": np.array([t for t, _ in fresh]),
                "field_name": np.array([f for _, f in fresh]),
            },
        )
        vals = [(table, f, v, c) for f, vs in fields.items() for v, c in vs.items()]
        self._values.emit(
            now,
            [(t, f, v) for t, f, v, _ in vals],
            lambda fresh: _value_rows(now, {(t, f, v): c for t, f, v, c in vals}, fresh),
        )

    def flush(self):
        self._fields.writer.flush()
        self._values.writer.flush()


def _value_rows(now, counts, fresh):
    return {
        "time": np.full(len(fresh), now, np.uint32),
        "table": np.array([t for t, _, _ in fresh]),
        "field_name": np.array([f for _, f, _ in fresh]),
        "field_value": np.array([v for _, _, v in fresh]),
        "count": np.array([counts[k] for k in fresh], np.uint64),
    }


class AppServiceTagWriter:
    """app_service/app_instance sidecar (app_service_tag_writer.go:92)."""

    def __init__(
        self, store: ColumnarStore, db: str = "flow_tag", cache_ttl_s: float = 600.0
    ):
        self._w = _CachedDictWriter(
            TableWriter(store, db, APP_SERVICE_SCHEMA, flush_interval_s=0.2), cache_ttl_s
        )

    def write(self, now: int, table: str, pairs: list[tuple[str, str]]) -> None:
        self._w.emit(
            now,
            [(table, s, i) for s, i in pairs if s],
            lambda fresh: {
                "time": np.full(len(fresh), now, np.uint32),
                "table": np.array([t for t, _, _ in fresh]),
                "app_service": np.array([s for _, s, _ in fresh]),
                "app_instance": np.array([i for _, _, i in fresh]),
            },
        )

    def flush(self):
        self._w.writer.flush()
