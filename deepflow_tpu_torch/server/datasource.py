"""Runtime-managed downsampling — the datasource manager (port of
deepflow_tpu/server/datasource.py).

The reference materializes coarser granularities inside ClickHouse:
`datasource/handle.go:316-463` creates an AggregatingMergeTree + a
materialized view per datasource (1m→1h→1d), with configurable
aggregations for summable vs. unsummable metrics and per-datasource
retention, managed at runtime over REST (:20106).

Here the store has no MV engine, so the downsampler *is* the view: each
DataSource tracks a partition watermark on its base table; `process()`
scans newly-closed partitions, re-keys rows to the coarser interval and
runs the same device sort→segment-reduce groupby as the ingest stash
(ops/segment.groupby_reduce, whose segmented reduce is the CUDA kernel
of kernels/segreduce.cu on the card), one call per chunk, writing
results into the derived table. Summable columns aggregate per their schema op (SUM/MAX);
unsummable (MAX-class) columns support the reference's Avg/Max choice —
Avg divides the per-group sum by the group's row count.

String (U256) columns join the group key via host-side factorization —
they are dictionary ids in all but representation. The group key is
hashed on the host (`fingerprint64_np`) and uploaded with the rows.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..datamodel.schema import MeterSchema
from ..device import resolve_device
from ..ops.hashing import fingerprint64_np
from ..ops.segment import groupby_reduce
from ..ops.u32 import from_numpy_u32, to_numpy_u32
from ..storage.store import ColumnarStore, ColumnSpec, TableSchema
from ..utils.stats import register_countable
from .metrics_tables import METER_OF_TABLE, METRICS_DB, MetricsTableID, TABLE_NAMES

_INTERVALS = {"1m": 60, "1h": 3600, "1d": 86400}

# -- cascade-served tiers ---------------------------------------------------
# The rollup cascade (aggregator/cascade.py) maintains 1m/1h tiers as
# device-side folds of closed finer windows — those granularities are
# SERVED without a datasource job. Pipelines register their tiers here
# at construction so the operator-facing datasource listings (dfctl
# datasource, REST /v1/datasources, the debug UDP "datasources" cmd)
# reflect which granularities the cascade covers vs which the
# store-side Downsampler materializes. Suffixes come from the
# querier's TIER_SUFFIX_S so a listed tier name is exactly the name
# bare-family tier routing can resolve (a non-standard interval is
# listed as "<N>s" but is NOT bare-name routable — query it by its
# explicit table name).

_FAMILIES_OF_METER = {
    "flow": ("network", "network_map"),
    "app": ("application", "application_map"),
    "usage": ("traffic_policy",),
}
_CASCADE_TIERS: dict[tuple[str, int], dict] = {}
# live registrants per tier (weakly held — the stats-registry stance:
# a torn-down pipeline's tiers leave the listing with it). A tier
# registered without an owner is permanent (operator/config-driven).
_CASCADE_OWNERS: dict[tuple[str, int], object] = {}


def register_cascade_tiers(meter_name: str, intervals, owner=None) -> None:
    """Record that a cascade now serves `intervals` (seconds) for every
    table family of `meter_name` ("flow"/"app"/"usage"). Idempotent —
    re-registering the same tier refreshes it. With `owner` (the
    serving pipeline/manager), the registration is weakly held and the
    tier drops out of the listing when the owner is collected."""
    import weakref

    from ..querier.translation import TIER_SUFFIX_S

    suffix_of_s = {s: n for n, s in TIER_SUFFIX_S.items()}
    for family in _FAMILIES_OF_METER.get(meter_name, (meter_name,)):
        for s in intervals:
            suffix = suffix_of_s.get(int(s), f"{int(s)}s")
            key = (family, int(s))
            _CASCADE_TIERS[key] = {
                "name": f"{family}_{suffix}",
                "base_table": f"{family}_1s",
                "interval": suffix,
                "served_by": "cascade",
            }
            owners = _CASCADE_OWNERS.setdefault(key, weakref.WeakSet())
            if owner is None:
                _CASCADE_OWNERS[key] = None  # permanent
            elif owners is not None:
                owners.add(owner)


def list_cascade_tiers() -> list[dict]:
    """Listing rows for the cascade-served tiers (stable order);
    weakly-owned tiers whose every registrant died are dropped."""
    out = []
    for key in sorted(_CASCADE_TIERS):
        owners = _CASCADE_OWNERS.get(key)
        if owners is not None and not len(owners):
            continue  # every registering pipeline is gone
        out.append(dict(_CASCADE_TIERS[key]))
    return out


@dataclasses.dataclass
class DataSource:
    """One derived granularity of a base metrics table."""

    base_table: str  # e.g. "network_1s"
    interval: str  # "1m" | "1h" | "1d"
    db: str = METRICS_DB
    aggr_unsummable: str = "avg"  # "avg" | "max" (handle.go summable/unsummable)
    retention_hours: int = 24 * 30
    # highest fully-processed chunk (units of chunk_s; persisted)
    watermark: int = -1

    def __post_init__(self):
        if self.interval not in _INTERVALS:
            raise ValueError(f"bad interval {self.interval}")
        if self.aggr_unsummable not in ("avg", "max"):
            raise ValueError(f"bad aggr {self.aggr_unsummable}")
        base_family = self.base_table.rsplit("_", 1)[0]
        self.name = f"{base_family}_{self.interval}"
        self.interval_s = _INTERVALS[self.interval]
        if self.name == self.base_table:
            raise ValueError(f"datasource {self.name} would write into its base table")


def _meter_schema_for(table: str) -> MeterSchema:
    family = table.replace(".", "_")
    for tid, name in TABLE_NAMES.items():
        if name.replace(".", "_") == family:
            return METER_OF_TABLE[tid]
    # derived tables (network_1h…) share the family's meter schema
    base = table.rsplit("_", 1)[0]
    for tid, name in TABLE_NAMES.items():
        if name.replace(".", "_").rsplit("_", 1)[0] == base:
            return METER_OF_TABLE[tid]
    raise KeyError(f"no meter schema for table {table}")


class Downsampler:
    """Owns the DataSource registry; `process()` advances watermarks.
    The rollups run on `device` (default CUDA; raises without it)."""

    def __init__(self, store: ColumnarStore, *, delay_s: int = 60, device=None):
        self.store = store
        self.delay_s = delay_s
        self.device = resolve_device(device)
        self._sources: dict[str, DataSource] = {}
        self._lock = threading.Lock()
        self._proc_lock = threading.Lock()
        self.counters = {"rows_in": 0, "rows_out": 0, "partitions": 0}
        register_countable("downsampler", self)

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    # -- registry (the REST surface, datasource/handle.go Add/Del) ------
    def add(self, ds: DataSource) -> DataSource:
        base_schema = self.store.schema(ds.db, ds.base_table)
        _meter_schema_for(ds.base_table)  # validates the table family
        native = {n.replace(".", "_") for n in TABLE_NAMES.values()}
        if ds.name in native:
            raise ValueError(
                f"datasource {ds.name} collides with a natively-ingested table"
            )
        target = TableSchema(
            ds.name,
            tuple(ColumnSpec(c.name, c.dtype) for c in base_schema.columns),
            time_column=base_schema.time_column,
            partition_s=max(base_schema.partition_s, ds.interval_s),
            ttl_hours=ds.retention_hours,
        )
        self.store.create_table(ds.db, target)
        ds.watermark = max(ds.watermark, self._load_watermark(ds))
        with self._lock:
            if ds.name in self._sources:
                raise ValueError(f"datasource {ds.name} exists")
            self._sources[ds.name] = ds
        return ds

    def delete(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def list(self) -> list[DataSource]:
        with self._lock:
            return list(self._sources.values())

    # -- watermark persistence ------------------------------------------
    _WM_SCHEMA = TableSchema(
        "datasource_watermark",
        (ColumnSpec("time", "u4"), ColumnSpec("name", "U128"), ColumnSpec("watermark", "i8")),
        partition_s=1 << 30,
    )

    def _load_watermark(self, ds: DataSource) -> int:
        self.store.create_table(ds.db, self._WM_SCHEMA)
        rows = self.store.scan(ds.db, "datasource_watermark")
        mine = rows["watermark"][rows["name"] == ds.name]
        return int(mine.max()) if len(mine) else -1

    def _save_watermark(self, ds: DataSource) -> None:
        self.store.insert(
            ds.db,
            "datasource_watermark",
            {
                "time": np.zeros(1, np.uint32),
                "name": np.array([ds.name]),
                "watermark": np.array([ds.watermark], np.int64),
            },
        )
        # compact: saves append one-row parts forever otherwise; fold to
        # one row per datasource once the part count grows
        if self.store.part_count(ds.db, "datasource_watermark", 0) > 64:
            rows = self.store.scan(ds.db, "datasource_watermark")
            best: dict[str, int] = {}
            for nm, wm in zip(rows["name"], rows["watermark"]):
                best[str(nm)] = max(best.get(str(nm), -1), int(wm))
            self.store.drop_partition(ds.db, "datasource_watermark", 0)
            self.store.insert(
                ds.db,
                "datasource_watermark",
                {
                    "time": np.zeros(len(best), np.uint32),
                    "name": np.array(list(best)),
                    "watermark": np.array(list(best.values()), np.int64),
                },
            )

    # -- processing -----------------------------------------------------
    def process(self, now: int) -> int:
        """Roll up all chunks fully closed before `now - delay`; returns
        total rows written. Serialized: a second concurrent call returns
        0 instead of double-processing the same chunks."""
        if not self._proc_lock.acquire(blocking=False):
            return 0
        try:
            total = 0
            for ds in self._topo_sources():
                total += self._process_one(ds, now)
            return total
        finally:
            self._proc_lock.release()

    def _topo_sources(self) -> list[DataSource]:
        """Dependency order: a datasource whose base table is itself a
        registered datasource (e.g. network_1h over network_1m) must run
        after that base has rolled the chunk, or it would scan the base
        table before the finer rollup wrote it, advance its watermark,
        and never re-roll the missing rows."""
        sources = self.list()
        by_name = {ds.name: ds for ds in sources}
        ordered: list[DataSource] = []
        seen: set[str] = set()

        def visit(ds: DataSource, chain: tuple[str, ...] = ()):
            if ds.name in seen:
                return
            if ds.name in chain:  # defensive: cycles can't roll anyway
                return
            base = by_name.get(ds.base_table)
            if base is not None:
                visit(base, chain + (ds.name,))
            seen.add(ds.name)
            ordered.append(ds)

        for ds in sources:
            visit(ds)
        return ordered

    def _process_one(self, ds: DataSource, now: int) -> int:
        """Scan in chunks of max(interval, partition) so every output
        group is complete: an interval window never spans two chunks
        (chunk is a multiple of interval) and a chunk never splits a
        partition (chunk is a multiple of partition_s)."""
        base_schema = self.store.schema(ds.db, ds.base_table)
        part_s = base_schema.partition_s
        chunk_s = max(ds.interval_s, part_s)
        closed_before = (now - self.delay_s) // chunk_s  # chunks < this are closed
        chunks = sorted(
            {
                p * part_s // chunk_s
                for p in self.store.partitions(ds.db, ds.base_table)
            }
        )
        written = 0
        for c in chunks:
            if not (ds.watermark < c < closed_before):
                continue
            t0, t1 = c * chunk_s, (c + 1) * chunk_s
            cols = self.store.scan(ds.db, ds.base_table, time_range=(t0, t1))
            n = len(cols[base_schema.time_column])
            if n:
                # chunk_s equals the derived table's partition_s, so one
                # chunk is exactly one target partition: dropping it first
                # makes re-rolls after a crash idempotent
                self.store.drop_partition(ds.db, ds.name, c)
                written += self._rollup(ds, base_schema, cols, n)
            ds.watermark = c
            self._save_watermark(ds)  # per chunk: crash re-rolls ≤1 chunk
            with self._lock:
                self.counters["partitions"] += 1
                self.counters["rows_in"] += n
        with self._lock:
            self.counters["rows_out"] += written
        return written

    def _rollup(self, ds: DataSource, base_schema: TableSchema, cols, n: int) -> int:
        meter = _meter_schema_for(ds.base_table)
        meter_names = set(meter.field_names())
        time_col = base_schema.time_column

        tag_names = [
            c.name
            for c in base_schema.columns
            if c.name != time_col and c.name not in meter_names
        ]
        int_tags, str_tags, str_values = [], [], {}
        for nm in tag_names:
            arr = cols[nm]
            if arr.dtype.kind == "U":
                codes, uniq = _factorize(arr)
                int_tags.append(codes)
                str_tags.append(nm)
                str_values[nm] = uniq
            else:
                int_tags.append(arr.astype(np.uint32))

        slot = (cols[time_col].astype(np.int64) // ds.interval_s).astype(np.uint32)
        key_mat = np.stack(int_tags, axis=1)
        hi, lo = fingerprint64_np(key_mat)

        meters = np.stack(
            [cols[f].astype(np.float32) for f in meter.field_names()], axis=1
        )
        sum_cols = np.nonzero(meter.sum_mask)[0].astype(np.int32)
        max_cols = np.nonzero(meter.max_mask)[0].astype(np.int32)
        if ds.aggr_unsummable == "avg":
            # unsummable → Avg: sum them (and a row-count column), divide
            # by the group's row count
            meters_in = np.concatenate([meters, np.ones((n, 1), np.float32)], axis=1)
            g_sum = np.concatenate([sum_cols, max_cols, [meters.shape[1]]]).astype(np.int32)
            g_max = np.array([], np.int32)
        else:
            meters_in, g_sum, g_max = meters, sum_cols, max_cols
        dev = self.device
        g = groupby_reduce(
            from_numpy_u32(slot, dev),
            from_numpy_u32(hi, dev),
            from_numpy_u32(lo, dev),
            from_numpy_u32(key_mat.T, dev),
            torch.from_numpy(np.ascontiguousarray(meters_in)).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            g_sum,
            g_max,
        )
        m = int(g.num_segments)
        out_tags = to_numpy_u32(g.tags[:, :m]).T
        out_meters = g.meters[:, :m].t().contiguous().cpu().numpy()  # a writable copy
        out_slot = to_numpy_u32(g.slot[:m]).astype(np.int64)
        if ds.aggr_unsummable == "avg" and max_cols.size:
            count = np.maximum(out_meters[:, -1], 1.0)
            out_meters[:, max_cols] = out_meters[:, max_cols] / count[:, None]
            out_meters = out_meters[:, :-1]
        elif ds.aggr_unsummable == "avg":
            out_meters = out_meters[:, :-1]

        out_cols: dict[str, np.ndarray] = {time_col: (out_slot * ds.interval_s).astype(np.uint32)}
        for j, nm in enumerate(tag_names):
            vals = out_tags[:, j]
            if nm in str_values:
                out_cols[nm] = str_values[nm][vals]
            else:
                out_cols[nm] = vals
        for j, f in enumerate(meter.field_names()):
            out_cols[f] = out_meters[:, j]
        self.store.insert(ds.db, ds.name, out_cols)
        return m


def _factorize(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    uniq, codes = np.unique(arr, return_inverse=True)
    return codes.astype(np.uint32), uniq
