"""Store monitor — TTL expiry + disk-watermark priority drops.

The ckmonitor seat (server/ingester/ckmonitor/monitor.go:75-206): the
reference checks ClickHouse disk usage against a watermark and
force-drops the oldest partitions, lowest-priority tables first, until
usage falls below it; TTL expiry runs alongside. Same protocol over the
columnar store: `check()` enforces per-table TTLs, then while
`disk_bytes()` exceeds `max_bytes` walks the priority ladder dropping
each victim table's OLDEST partition (never the newest — that is the
live write head).

Port copy of deepflow_tpu/storage/monitor.py.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from .store import ColumnarStore

_ORG_PREFIX = re.compile(r"^\d{4}_")  # org_db() prefixes non-default orgs

# drop order under disk pressure (lowest value drops first) — raw and
# log planes are sacrificed before aggregated metrics, matching the
# reference's priority list stance
DEFAULT_PRIORITIES = {
    "pcap": 0,
    "application_log": 1,
    "flow_log": 2,
    "profile": 3,
    "ext_metrics": 4,
    "deepflow_stats": 4,
    "prometheus": 5,
    "event": 6,
    "flow_metrics": 7,
}
_DEFAULT_PRIORITY = 5


@dataclasses.dataclass
class StoreMonitor:
    store: ColumnarStore
    max_bytes: int | None = None  # None = no watermark enforcement
    ttl_hours: dict = dataclasses.field(default_factory=dict)  # (db, table) → h
    priorities: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_PRIORITIES))

    def __post_init__(self):
        self.counters = {"ttl_dropped": 0, "watermark_dropped": 0, "checks": 0}

    def get_counters(self):
        return dict(self.counters)

    # -- TTL -------------------------------------------------------------
    def _expire_ttl(self, now: int) -> int:
        """Per-table TTLs: explicit overrides first, else the TTL the
        table's schema carries (every TableSchema has ttl_hours)."""
        dropped = 0
        for db in self.store.databases():
            for table in self.store.tables(db):
                try:
                    schema = self.store.schema(db, table)
                except KeyError:
                    continue
                hours = self.ttl_hours.get(
                    (db, table), getattr(schema, "ttl_hours", 0)
                )
                if not hours:
                    continue
                cutoff_pid = (now - hours * 3600) // schema.partition_s
                for pid in self.store.partitions(db, table):
                    if pid < cutoff_pid:
                        self.store.drop_partition(db, table, pid)
                        dropped += 1
        return dropped

    # -- watermark -------------------------------------------------------
    def _priority(self, db: str) -> int:
        base = _ORG_PREFIX.sub("", db)  # org-prefixed dbs share the base priority
        for key, pri in self.priorities.items():
            if base == key or base.startswith(key):
                return pri
        return _DEFAULT_PRIORITY

    def _victims(self):
        """(priority, oldest_pid, db, table) for every droppable table —
        tables with ≥2 partitions only, so the live head survives."""
        out = []
        for db in self.store.databases():
            pri = self._priority(db)
            for table in self.store.tables(db):
                pids = self.store.partitions(db, table)
                if len(pids) >= 2:
                    out.append((pri, pids[0], db, table))
        out.sort()
        return out

    def _partition_bytes(self, db: str, table: str, pid: int) -> int:
        t = self.store._get(db, table)
        with self.store._lock:
            parts = list(t.parts.get(pid, []))
        total = 0
        for p in parts:
            if isinstance(p, Path):
                try:
                    total += p.stat().st_size
                except OSError:
                    pass
            else:  # in-memory part: approximate array bytes
                total += sum(getattr(a, "nbytes", 0) for a in p.values())
        return total

    def _enforce_watermark(self) -> tuple[int, int]:
        """Returns (dropped, disk_bytes_after). disk_bytes() is a full
        stat() walk, so it runs ONCE; each drop subtracts the victim's
        measured size instead of re-walking."""
        if self.max_bytes is None:
            return 0, -1
        used = self.store.disk_bytes()
        dropped = 0
        while used > self.max_bytes:
            victims = self._victims()
            if not victims:
                break
            _pri, pid, db, table = victims[0]
            used -= self._partition_bytes(db, table, pid)
            self.store.drop_partition(db, table, pid)
            dropped += 1
        return dropped, used

    def check(self, now: int) -> dict:
        """One monitor pass; call from the server tick."""
        self.counters["checks"] += 1
        t = self._expire_ttl(now)
        w, used = self._enforce_watermark()
        self.counters["ttl_dropped"] += t
        self.counters["watermark_dropped"] += w
        return {"ttl_dropped": t, "watermark_dropped": w, "disk_bytes": used}
