"""Metrics table routing + the store-backed document writer.
Port copy of deepflow_tpu/server/metrics_tables.py.

The reference routes each Document to a `MetricsTableID` — network /
network_map / application / application_map × {1m, 1s} plus
traffic_policy.1m — from its Code combination and flags
(server/libs/flow-metrics/tag.go:446-520), then appends columnar blocks
via ckwriter. `DocStoreWriter` is that seat for the TPU build: it takes
`EnrichedBatch`es from the flow_metrics ingester, splits rows by table id
(meter discriminant × edge-ness × granularity), widens tag + enrichment
+ meter columns into the table schema, and feeds per-table TableWriters,
with the app_service flow_tag sidecar written alongside
(unmarshaller.go:259-270).
"""

from __future__ import annotations

import enum
import threading

import numpy as np

from ..datamodel.code import CodeId, DocumentFlag, MeterId
from ..datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA, USAGE_METER, MeterSchema
from ..enrich.platform import ENRICH_FIELDS
from ..storage.flow_tag import AppServiceTagWriter
from ..storage.store import ColumnarStore, ColumnSpec, TableSchema, org_db
from ..storage.writer import TableWriter
from .flow_metrics import EnrichedBatch

METRICS_DB = "flow_metrics"


class MetricsTableID(enum.IntEnum):
    # tag.go:446-461 ordering.
    NETWORK_1M = 0
    NETWORK_MAP_1M = 1
    APPLICATION_1M = 2
    APPLICATION_MAP_1M = 3
    NETWORK_1S = 4
    NETWORK_MAP_1S = 5
    APPLICATION_1S = 6
    APPLICATION_MAP_1S = 7
    TRAFFIC_POLICY_1M = 8


TABLE_NAMES = {
    MetricsTableID.NETWORK_1M: "network.1m",
    MetricsTableID.NETWORK_MAP_1M: "network_map.1m",
    MetricsTableID.APPLICATION_1M: "application.1m",
    MetricsTableID.APPLICATION_MAP_1M: "application_map.1m",
    MetricsTableID.NETWORK_1S: "network.1s",
    MetricsTableID.NETWORK_MAP_1S: "network_map.1s",
    MetricsTableID.APPLICATION_1S: "application.1s",
    MetricsTableID.APPLICATION_MAP_1S: "application_map.1s",
    MetricsTableID.TRAFFIC_POLICY_1M: "traffic_policy.1m",
}

METER_OF_TABLE: dict[MetricsTableID, MeterSchema] = {
    MetricsTableID.NETWORK_1M: FLOW_METER,
    MetricsTableID.NETWORK_MAP_1M: FLOW_METER,
    MetricsTableID.APPLICATION_1M: APP_METER,
    MetricsTableID.APPLICATION_MAP_1M: APP_METER,
    MetricsTableID.NETWORK_1S: FLOW_METER,
    MetricsTableID.NETWORK_MAP_1S: FLOW_METER,
    MetricsTableID.APPLICATION_1S: APP_METER,
    MetricsTableID.APPLICATION_MAP_1S: APP_METER,
    MetricsTableID.TRAFFIC_POLICY_1M: USAGE_METER,
}

# string-dictionary side columns carried per row (codec service_ids order)
_SERVICE_COLS = ("app_service", "app_instance", "endpoint")


def table_schema(tid: MetricsTableID, partition_s: int = 3600, ttl_hours: int = 168) -> TableSchema:
    meter = METER_OF_TABLE[tid]
    cols = [ColumnSpec("time", "u4")]
    cols += [ColumnSpec(f.name, "u4") for f in TAG_SCHEMA.fields]
    cols += [ColumnSpec(f"{f}_0", "u4") for f in ENRICH_FIELDS]
    cols += [ColumnSpec(f"{f}_1", "u4") for f in ENRICH_FIELDS]
    cols += [ColumnSpec(c, "U256") for c in _SERVICE_COLS]
    cols += [ColumnSpec(f.name, "f4") for f in meter.fields]
    return TableSchema(
        TABLE_NAMES[tid].replace(".", "_"),
        tuple(cols),
        partition_s=partition_s,
        ttl_hours=ttl_hours,
    )


def route_table_ids(
    meter_id: int, code_id: np.ndarray, flags: np.ndarray
) -> np.ndarray:
    """Vectorized doc.TableID(): [N] code ids + flags → [N] MetricsTableID."""
    is_edge = (code_id >= CodeId.EDGE_IP_PORT) & (code_id <= CodeId.EDGE_MAC_IP_PORT_APP)
    is_sec = (flags & int(DocumentFlag.PER_SECOND_METRICS)) != 0
    if meter_id == MeterId.USAGE:
        return np.full(code_id.shape, int(MetricsTableID.TRAFFIC_POLICY_1M), np.int32)
    if meter_id == MeterId.APP:
        base = np.where(
            is_sec,
            np.where(is_edge, MetricsTableID.APPLICATION_MAP_1S, MetricsTableID.APPLICATION_1S),
            np.where(is_edge, MetricsTableID.APPLICATION_MAP_1M, MetricsTableID.APPLICATION_1M),
        )
    else:
        base = np.where(
            is_sec,
            np.where(is_edge, MetricsTableID.NETWORK_MAP_1S, MetricsTableID.NETWORK_1S),
            np.where(is_edge, MetricsTableID.NETWORK_MAP_1M, MetricsTableID.NETWORK_1M),
        )
    return base.astype(np.int32)


class DocStoreWriter:
    """EnrichedBatch → per-(org, table) columnar writes + flow_tag sidecar."""

    def __init__(
        self,
        store: ColumnarStore,
        *,
        partition_s: int = 3600,
        ttl_hours: int = 168,
        writer_args: dict | None = None,
        exporter_hub=None,
        live_registry=None,
    ):
        self.store = store
        self.partition_s = partition_s
        self.ttl_hours = ttl_hours
        self.writer_args = writer_args or {}
        self.exporter_hub = exporter_hub
        # With a LiveRegistry
        # attached, every per-table writer registers its pending rows
        # as a live source — the server-layer network/application
        # families answer range-ending-now queries with partial rows
        # (and live-aware tier selection prefers them) instead of going
        # dark for the writer's flush interval
        self.live_registry = live_registry
        self._writers: dict[tuple[str, MetricsTableID], TableWriter] = {}
        self._app_tags = AppServiceTagWriter(store)
        self._lock = threading.Lock()
        self.counters = {"rows": 0, "batches": 0}

    def _writer(self, db: str, tid: MetricsTableID) -> TableWriter:
        with self._lock:
            w = self._writers.get((db, tid))
            if w is None:
                w = TableWriter(
                    self.store,
                    db,
                    table_schema(tid, self.partition_s, self.ttl_hours),
                    live_registry=self.live_registry,
                    **self.writer_args,
                )
                self._writers[(db, tid)] = w
            return w

    def put(self, batch: EnrichedBatch) -> None:
        d = batch.decoded
        keep = np.asarray(batch.keep, bool)
        if not keep.any():
            return
        db = org_db(METRICS_DB, batch.header.organization_id)
        tids = route_table_ids(
            d.meter_id, d.tags[:, TAG_SCHEMA.index("code_id")], d.flags
        )
        strings = d.strings
        svc = d.service_ids
        for tid_val in np.unique(tids[keep]):
            tid = MetricsTableID(int(tid_val))
            sel = keep & (tids == tid_val)
            cols: dict[str, np.ndarray] = {"time": d.timestamp[sel]}
            for i, f in enumerate(TAG_SCHEMA.fields):
                cols[f.name] = d.tags[sel, i]
            for side in (0, 1):
                enriched = batch.side0 if side == 0 else batch.side1
                for f in ENRICH_FIELDS:
                    cols[f"{f}_{side}"] = (
                        np.asarray(enriched[f])[sel]
                        if enriched is not None
                        else np.zeros(int(sel.sum()), np.uint32)
                    )
            for j, name in enumerate(_SERVICE_COLS):
                cols[name] = np.array([strings.lookup(int(x)) for x in svc[sel, j]])
            for j, f in enumerate(METER_OF_TABLE[tid].fields):
                cols[f.name] = d.meters[sel, j]
            self._writer(db, tid).put(cols)
            if self.exporter_hub is not None:
                # exporters tap enriched columns post-routing
                # (unmarshaller.go:284-303 export point)
                self.exporter_hub.export(TABLE_NAMES[tid].replace(".", "_"), cols)
            # app_service sidecar rows for docs that carry a service string
            pairs = {
                (strings.lookup(int(s)), strings.lookup(int(i)))
                for s, i in svc[sel, :2]
                if int(s) != 0
            }
            if pairs:
                self._app_tags.write(
                    int(d.timestamp[sel][0]),
                    TABLE_NAMES[tid].replace(".", "_"),
                    sorted(pairs),
                )
        with self._lock:
            self.counters["rows"] += int(keep.sum())
            self.counters["batches"] += 1

    def flush(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.flush()
        self._app_tags.flush()

    def stop(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.stop()
