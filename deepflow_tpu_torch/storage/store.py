"""Partitioned columnar table store — the ClickHouse seat.
Port copy of deepflow_tpu/storage/store.py.

The reference writes batched columnar blocks over the CK native protocol
into MergeTree tables partitioned by time, with org-id database prefixes
(`<org>_flow_metrics`, server/libs/ckdb/table.go:120) and TTL/partition
drops enforced by ckmonitor. This store keeps the same shape the TPU-host
way: a table is a directory of immutable columnar *parts* (one `.npz` per
flushed write batch, time-partitioned); scans mmap-load only the parts
overlapping the query range and concatenate columns. There is no
merge-on-read — rollups are the downsampler's job, matching the
reference's "docs are written as-is" stance (flow_metrics.go).

In-memory mode (root="") backs tests and the zero-dependency bring-up
path; the on-disk layout is `<root>/<db>/<table>/p<partition>_<seq>.npz`.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import re
import threading
from pathlib import Path

import numpy as np

_STORE_UIDS = itertools.count(1)

DEFAULT_ORG_ID = 1
_NAME_RE = re.compile(r"^[A-Za-z0-9_.]+$")


def org_db(base: str, org_id: int = DEFAULT_ORG_ID) -> str:
    """Org-aware database naming (ckdb/table.go:120 IsDefaultOrgID)."""
    if org_id in (0, DEFAULT_ORG_ID):
        return base
    return f"{org_id:04d}_{base}"


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    # numpy dtype string: "u4", "f4", "i8", "U64"… — or "O" for a
    # variable-width string column (the ClickHouse String analogue:
    # values are never clipped to a fixed width; each on-disk part
    # stores them at that part's own max width)
    dtype: str


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSpec, ...]
    time_column: str = "time"
    partition_s: int = 3600
    ttl_hours: int = 168
    version: int = 1

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate columns in {self.name}")
        if self.time_column not in names:
            raise ValueError(f"{self.name}: missing time column {self.time_column}")

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "columns": [[c.name, c.dtype] for c in self.columns],
                "time_column": self.time_column,
                "partition_s": self.partition_s,
                "ttl_hours": self.ttl_hours,
                "version": self.version,
            }
        )

    @staticmethod
    def from_json(text: str) -> "TableSchema":
        d = json.loads(text)
        return TableSchema(
            name=d["name"],
            columns=tuple(ColumnSpec(n, t) for n, t in d["columns"]),
            time_column=d["time_column"],
            partition_s=d["partition_s"],
            ttl_hours=d["ttl_hours"],
            version=d.get("version", 1),
        )


def _load_part(chunk):
    """Load a part, tolerating concurrent drop_partition unlinks."""
    if not isinstance(chunk, Path):
        return chunk
    try:
        return np.load(chunk)
    except FileNotFoundError:
        return None


class _Table:
    def __init__(self, schema: TableSchema, path: Path | None):
        self.schema = schema
        self.path = path
        self.parts: dict[int, list] = {}  # partition → [np dict | Path]
        self.seq = 0
        # monotonically increasing write epoch: bumped on
        # every insert/drop so the querier's result cache can validate
        # an entry with one integer compare instead of re-scanning —
        # window close → flushed rows insert → epoch moves → stale
        self.mutations = 0


class ColumnarStore:
    """db → table → time-partitioned columnar parts."""

    def __init__(self, root: str | Path = ""):
        self.root = Path(root) if root else None
        self._dbs: dict[str, dict[str, _Table]] = {}
        self._lock = threading.Lock()
        # process-unique store identity: result-cache keys must never
        # collide across two stores (id() can be reused after GC —
        # same-looking mutation counts on a recycled address would
        # serve one store's cached rows for another's query)
        self.uid = next(_STORE_UIDS)
        # push query plane: optional mutation hook, called
        # (db, table, epoch) OUTSIDE the lock after every insert/drop —
        # querier/events.connect_store_events points it at a
        # QueryEventBus so a window close push-invalidates standing
        # queries the instant its flushed rows land
        self._mutation_hook = None
        # window lineage plane: optional scan hooks, called
        # (db, table, time_range) after every scan resolves its table —
        # tracing/lineage.connect_store_reads marks a flushed window's
        # first query (query.first hop) from here. A LIST (unlike the
        # single mutation hook): multiple trackers may watch different
        # tables of one store.
        self._scan_hooks: list = []
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
            self._load_existing()

    # -- bootstrap ------------------------------------------------------
    def _load_existing(self):
        for schema_file in self.root.glob("*/*/schema.json"):
            schema = TableSchema.from_json(schema_file.read_text())
            db = schema_file.parent.parent.name
            t = _Table(schema, schema_file.parent)
            for part in sorted(schema_file.parent.glob("p*_*.npz")):
                pid, seq = part.stem[1:].split("_")
                t.parts.setdefault(int(pid), []).append(part)
                t.seq = max(t.seq, int(seq) + 1)
            self._dbs.setdefault(db, {})[schema.name] = t

    # -- DDL ------------------------------------------------------------
    def create_table(self, db: str, schema: TableSchema) -> None:
        if not _NAME_RE.match(db) or not _NAME_RE.match(schema.name):
            raise ValueError(f"bad identifier {db!r}/{schema.name!r}")
        with self._lock:
            tables = self._dbs.setdefault(db, {})
            if schema.name in tables:
                return
            path = None
            if self.root is not None:
                path = self.root / db / schema.name
                path.mkdir(parents=True, exist_ok=True)
                (path / "schema.json").write_text(schema.to_json())
            tables[schema.name] = _Table(schema, path)

    def databases(self) -> list[str]:
        with self._lock:
            return sorted(self._dbs)

    def tables(self, db: str) -> list[str]:
        with self._lock:
            return sorted(self._dbs.get(db, {}))

    def schema(self, db: str, table: str) -> TableSchema:
        return self._get(db, table).schema

    def _get(self, db: str, table: str) -> _Table:
        with self._lock:
            try:
                return self._dbs[db][table]
            except KeyError:
                raise KeyError(f"no such table {db}.{table}") from None

    # -- DML ------------------------------------------------------------
    def insert(self, db: str, table: str, cols: dict[str, np.ndarray]) -> int:
        """Append one part per touched partition; returns rows written."""
        t = self._get(db, table)
        s = t.schema
        missing = [c.name for c in s.columns if c.name not in cols]
        if missing:
            raise ValueError(f"{db}.{table}: missing columns {missing}")
        n = len(cols[s.time_column])
        if n == 0:
            return 0
        arrs = {
            c.name: np.ascontiguousarray(cols[c.name], dtype=np.dtype(c.dtype))
            for c in s.columns
        }
        if any(len(a) != n for a in arrs.values()):
            raise ValueError(f"{db}.{table}: ragged columns")
        ts = arrs[s.time_column].astype(np.int64)
        pids = ts // s.partition_s
        unique_pids = [int(p) for p in np.unique(pids)]
        # reserve sequence numbers under the lock, compress/write outside
        # it (savez_compressed is the slow part — it must not serialize
        # unrelated tables' flushes or block scans), then publish
        with self._lock:
            seq0 = t.seq
            t.seq += len(unique_pids)
        written: list[tuple[int, object]] = []
        for i, pid in enumerate(unique_pids):
            sel = pids == pid
            part = {k: v[sel] for k, v in arrs.items()}
            if t.path is not None:
                f = t.path / f"p{pid}_{seq0 + i}.npz"
                # object (variable-width string) columns serialize as a
                # U<part-max> array — npz can't hold object arrays
                # without pickle, and per-part sizing keeps them
                # unclipped; load returns them as U<n>, which scan
                # concatenation promotes freely
                np.savez_compressed(
                    f,
                    **{
                        k: (v.astype(np.str_) if v.dtype == object else v)
                        for k, v in part.items()
                    },
                )
                written.append((pid, f))
            else:
                written.append((pid, part))
        with self._lock:
            for pid, part in written:
                t.parts.setdefault(pid, []).append(part)
            t.mutations += 1
            epoch = t.mutations
        self._notify_mutation(db, table, epoch)
        return n

    def set_mutation_hook(self, hook) -> None:
        """`hook(db, table, epoch)` fires after every insert/drop (None
        detaches). Called outside the store lock; exceptions are
        contained — a broken event plane must never fail a write."""
        self._mutation_hook = hook

    def _notify_mutation(self, db: str, table: str, epoch: int) -> None:
        hook = self._mutation_hook
        if hook is None:
            return
        try:
            hook(db, table, epoch)
        except Exception:
            logging.getLogger(__name__).debug(
                "store mutation hook failed for %s.%s (contained)",
                db, table, exc_info=True,
            )

    def add_scan_hook(self, hook) -> None:
        """`hook(db, table, time_range)` fires after every successful
        scan (exceptions contained — observability must never fail a
        read). The lineage plane's query.first seam."""
        self._scan_hooks.append(hook)

    def remove_scan_hook(self, hook) -> None:
        if hook in self._scan_hooks:
            self._scan_hooks.remove(hook)

    def _notify_scan(self, db: str, table: str, time_range) -> None:
        for hook in list(self._scan_hooks):
            try:
                hook(db, table, time_range)
            except Exception:
                logging.getLogger(__name__).debug(
                    "store scan hook failed for %s.%s (contained)",
                    db, table, exc_info=True,
                )

    def scan(
        self,
        db: str,
        table: str,
        time_range: tuple[int, int] | None = None,
        columns: list[str] | None = None,
    ) -> dict[str, np.ndarray]:
        """Read columns across parts overlapping [t0, t1); row-filtered
        exactly on the time column."""
        t = self._get(db, table)
        s = t.schema
        names = columns if columns is not None else s.column_names()
        for nm in names:
            if nm not in s.column_names():
                raise KeyError(f"{db}.{table}: no column {nm}")
        read = list(dict.fromkeys(names + [s.time_column]))
        with self._lock:
            if time_range is None:
                pids = sorted(t.parts)
            else:
                p0 = time_range[0] // s.partition_s
                p1 = (time_range[1] - 1) // s.partition_s
                pids = sorted(p for p in t.parts if p0 <= p <= p1)
            chunks = [p for pid in pids for p in list(t.parts[pid])]
        cols: dict[str, list[np.ndarray]] = {nm: [] for nm in read}
        for chunk in chunks:
            data = _load_part(chunk)
            if data is None:  # partition dropped mid-scan
                continue
            ts = np.asarray(data[s.time_column])
            if time_range is not None:
                sel = (ts >= time_range[0]) & (ts < time_range[1])
                if not sel.any():
                    continue
                for nm in read:
                    cols[nm].append(np.asarray(data[nm])[sel])
            else:
                for nm in read:
                    cols[nm].append(np.asarray(data[nm]))
        empty = {
            c.name: np.empty(0, np.dtype(c.dtype)) for c in s.columns if c.name in read
        }
        out = {
            nm: (np.concatenate(cols[nm]) if cols[nm] else empty[nm]) for nm in names
        }
        if self._scan_hooks:
            # AFTER the read completed — a failed scan must not mark a
            # window as queried (add_scan_hook's contract)
            self._notify_scan(db, table, time_range)
        return out

    def row_count(self, db: str, table: str) -> int:
        t = self._get(db, table)
        with self._lock:
            chunks = [p for parts in t.parts.values() for p in parts]
        total = 0
        for chunk in chunks:
            data = _load_part(chunk)
            if data is None:
                continue
            total += len(np.asarray(data[t.schema.time_column]))
        return total

    # -- retention (ckmonitor hooks) ------------------------------------
    def partitions(self, db: str, table: str) -> list[int]:
        t = self._get(db, table)
        with self._lock:
            return sorted(t.parts)

    def part_count(self, db: str, table: str, pid: int) -> int:
        t = self._get(db, table)
        with self._lock:
            return len(t.parts.get(pid, []))

    def drop_partition(self, db: str, table: str, pid: int) -> None:
        t = self._get(db, table)
        with self._lock:
            for part in t.parts.pop(pid, []):
                if isinstance(part, Path):
                    part.unlink(missing_ok=True)
            t.mutations += 1
            epoch = t.mutations
        self._notify_mutation(db, table, epoch)

    def mutation_count(self, db: str, table: str) -> int:
        """Write epoch of one table (0 for a table that does not exist
        yet — its creation bumps nothing, but the first insert does).
        The querier's result cache validates entries against this: one
        int compare per lookup, no scan."""
        with self._lock:
            t = self._dbs.get(db, {}).get(table)
            return 0 if t is None else t.mutations

    def disk_bytes(self, db: str | None = None) -> int:
        with self._lock:
            tabs = [
                t
                for d, ts in self._dbs.items()
                if db is None or d == db
                for t in ts.values()
            ]
            chunks = [p for t in tabs for parts in t.parts.values() for p in parts]
        total = 0
        for chunk in chunks:
            if isinstance(chunk, Path):
                total += chunk.stat().st_size if chunk.exists() else 0
            else:
                total += sum(a.nbytes for a in chunk.values())
        return total
