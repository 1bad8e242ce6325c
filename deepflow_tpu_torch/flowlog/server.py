"""flow_log ingester — TAGGEDFLOW / PROTOCOLLOG frames → storage rows.

Port copy of deepflow_tpu/flowlog/server.py.

The TPU re-composition of server/ingester/flow_log: receiver fanout into
per-type decode queues (decoder/decoder.go:150), schema-driven columnar
decode, per-second throttled sampling (throttler/throttling_queue.go),
device tag enrichment (the L4/L7FlowLog.Fill PlatformInfoTable queries,
log_data/l4_flow_log.go), and batched columnar writes into the
`flow_log` database (l4_flow_log / l7_flow_log tables).

Enrichment rides the metrics path's `enrich_docs` on the platform
state's device: log identity columns are gathered into a
TAG_SCHEMA-shaped matrix (edge Code so both sides resolve) and come
back in one packed fetch per batch (`server.flow_metrics.enrich_chunk_host`).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..datamodel.code import CodeId
from ..datamodel.schema import TAG_SCHEMA
from ..enrich.platform import ENRICH_FIELDS, PlatformState
from ..ingest.framing import HEADER_LEN, FlowHeader, MessageType, split_messages
from ..ingest.queues import new_queue
from ..ingest.receiver import Receiver
from ..server.flow_metrics import enrich_chunk_host
from ..storage.store import ColumnarStore, ColumnSpec, TableSchema, org_db
from ..storage.writer import TableWriter
from ..utils.stats import register_countable
from .aggr import FlowLogBatch, ThrottlingQueue
from .codec import decode_rows
from .schema import L4_FLOW_LOG, L7_FLOW_LOG, LogSchema

FLOW_LOG_DB = "flow_log"

# log int column → TAG_SCHEMA column feeding the enrichment kernel
_TAG_FROM_LOG = {
    "agent_id": "agent_id",
    "is_ipv6": "is_ipv6",
    **{f"ip{s}_w{w}": f"ip{s}_w{w}" for s in (0, 1) for w in range(4)},
    "l3_epc_id_0": "l3_epc_id",
    "l3_epc_id_1": "l3_epc_id1",
    "server_port": "server_port",
    "protocol": "protocol",
    "tap_side": "tap_side",
    "gpid_0": "gpid0",
    "gpid_1": "gpid1",
    "signal_source": "signal_source",
    "l7_protocol": "l7_protocol",
    "pod_id_0": "pod_id",
}


# table columns provided by enrichment; same-named raw log ints (the
# agent-reported pod ids) feed the kernel but the enriched value is what
# lands in the table (DocumentExpand overwrite stance)
_ENRICH_COLS = {f"{f}_{s}" for f in ENRICH_FIELDS for s in (0, 1)}


def log_table_schema(schema: LogSchema, partition_s: int = 3600) -> TableSchema:
    cols = [ColumnSpec("time", "u4")]
    cols += [ColumnSpec(f.name, "u4") for f in schema.ints if f.name not in _ENRICH_COLS]
    cols += [ColumnSpec(f.name, "f4") for f in schema.nums]
    cols += [ColumnSpec(f.name, "U256") for f in schema.strs]
    cols += [ColumnSpec(f"{f}_{s}", "u4") for s in (0, 1) for f in ENRICH_FIELDS]
    return TableSchema(schema.name, tuple(cols), partition_s=partition_s)


def log_batch_to_columns(
    batch: FlowLogBatch, enrich0: dict | None = None, enrich1: dict | None = None
) -> dict[str, np.ndarray]:
    """FlowLogBatch → storage columns for log_table_schema tables.

    THE one assembly for every l7/l4 log write path (throttled ingest,
    OTel spans, future sources): time from end_time, raw ints except the
    enrichment-owned columns, nums, strings, and per-side enrich columns
    (from the given dicts, falling back to raw agent-reported ints, then
    zeros)."""
    schema = batch.schema
    cols: dict[str, np.ndarray] = {"time": batch.col("end_time").astype(np.uint32)}
    for i, f in enumerate(schema.ints):
        if f.name not in _ENRICH_COLS:
            cols[f.name] = batch.ints[:, i]
    for i, f in enumerate(schema.nums):
        cols[f.name] = batch.nums[:, i]
    for f in schema.strs:
        cols[f.name] = np.array(batch.strs[f.name] if batch.strs else [""] * batch.size)
    for side, enriched in ((0, enrich0), (1, enrich1)):
        for f in ENRICH_FIELDS:
            name = f"{f}_{side}"
            if enriched is not None:
                cols[name] = np.asarray(enriched[f])[: batch.size]
            elif name in schema._int_idx:
                cols[name] = batch.ints[:, schema.int_index(name)]
            else:
                cols[name] = np.zeros(batch.size, np.uint32)
    return cols


def _tags_for_enrich(batch: FlowLogBatch) -> np.ndarray:
    n = batch.size
    p = max(1, 1 << (n - 1).bit_length())  # pad to pow2 → O(log N) jit shapes
    tags = np.zeros((p, TAG_SCHEMA.num_fields), np.uint32)
    s = batch.schema
    for log_col, tag_col in _TAG_FROM_LOG.items():
        if log_col in s._int_idx:
            tags[:n, TAG_SCHEMA.index(tag_col)] = batch.ints[:, s.int_index(log_col)]
    # edge Code: both endpoints resolve (l4_flow_log enriches both sides)
    tags[:n, TAG_SCHEMA.index("code_id")] = np.uint32(CodeId.EDGE_IP_PORT)
    valid = np.zeros(p, bool)
    valid[:n] = batch.valid
    return tags, valid, n


class FlowLogIngester:
    """TAGGEDFLOW + PROTOCOLLOG pipelines → flow_log db."""

    def __init__(
        self,
        receiver: Receiver,
        store: ColumnarStore,
        *,
        platform_state: PlatformState | None = None,
        l4_throttle: int = 50000,
        l7_throttle: int = 50000,
        n_workers: int = 1,
        queue_capacity: int = 1 << 14,
        batch_size: int = 128,
        writer_args: dict | None = None,
    ):
        self.store = store
        self.platform_state = platform_state
        self.batch_size = batch_size
        self.writer_args = writer_args or {}
        self._writers: dict[tuple[str, str], TableWriter] = {}
        self._throttles = {
            MessageType.TAGGEDFLOW: l4_throttle,
            MessageType.PROTOCOLLOG: l7_throttle,
        }
        self._schemas = {
            MessageType.TAGGEDFLOW: L4_FLOW_LOG,
            MessageType.PROTOCOLLOG: L7_FLOW_LOG,
        }
        self.counters = {
            "frames_in": 0,
            "rows_in": 0,
            "rows_written": 0,
            "decode_errors": 0,
            "throttle_dropped": 0,
        }
        self._lock = threading.Lock()
        self._running = True
        self._threads = []
        self.queues = {}
        for mt in (MessageType.TAGGEDFLOW, MessageType.PROTOCOLLOG):
            qs = [new_queue(queue_capacity, prefer_native=False) for _ in range(n_workers)]
            receiver.register_handler(mt, qs)
            self.queues[mt] = qs
            for q in qs:
                t = threading.Thread(target=self._worker, args=(mt, q), daemon=True)
                t.start()
                self._threads.append(t)
        register_countable("flow_log_ingester", self)

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    def _writer(self, db: str, schema: LogSchema) -> TableWriter:
        with self._lock:
            w = self._writers.get((db, schema.name))
            if w is None:
                w = TableWriter(
                    self.store, db, log_table_schema(schema), **self.writer_args
                )
                self._writers[(db, schema.name)] = w
            return w

    # -- worker ---------------------------------------------------------
    def _worker(self, mt: MessageType, q) -> None:
        """One throttler per (worker, org): reservoirs and org→db
        attribution must not mix tenants (the reference fans out by org at
        the receiver; here the queue is shared so the split is per-org)."""
        schema = self._schemas[mt]
        throttlers: dict[int, ThrottlingQueue] = {}
        max_sec: dict[int, int] = {}
        dropped_prev: dict[int, int] = {}
        idle_since: float | None = None
        HOLD_S = 0.3  # how long a stream pause closes the current second

        def _account_drops(org: int, thr: ThrottlingQueue) -> None:
            d = thr.counters["dropped"]
            delta = d - dropped_prev.get(org, 0)
            dropped_prev[org] = d
            if delta:
                with self._lock:
                    self.counters["throttle_dropped"] += delta

        while self._running:
            frames = q.gets(self.batch_size, timeout_ms=100)
            if not frames:
                # stream pause: the in-flight second is wall-clock closed
                # after HOLD_S — drain fully so rows never strand; shorter
                # pauses only drain seconds older than the newest seen
                now = time.monotonic()
                idle_since = idle_since or now
                full = now - idle_since >= HOLD_S
                for org, thr in throttlers.items():
                    up_to = None if full else max_sec.get(org)
                    self._emit(mt, thr.drain(up_to_sec=up_to), org)
                    _account_drops(org, thr)
                continue
            idle_since = None
            for raw in frames:
                try:
                    header = FlowHeader.parse(raw[:HEADER_LEN])
                    msgs = split_messages(raw[HEADER_LEN:])
                except ValueError:
                    with self._lock:
                        self.counters["decode_errors"] += 1
                    continue
                org = header.organization_id
                batch, errors = decode_rows(schema, msgs)
                with self._lock:
                    self.counters["frames_in"] += 1
                    self.counters["rows_in"] += int(batch.valid.sum())
                    self.counters["decode_errors"] += errors
                thr = throttlers.get(org)
                if thr is None:
                    thr = throttlers[org] = ThrottlingQueue(self._throttles[mt])
                thr.put(batch)
                sec = int(batch.col("end_time").max(initial=0))
                if sec > max_sec.get(org, 0):
                    # buckets strictly older than the newest second are closed
                    max_sec[org] = sec
                    self._emit(mt, thr.drain(up_to_sec=sec), org)
                _account_drops(org, thr)
        for org, thr in throttlers.items():  # shutdown: flush everything
            self._emit(mt, thr.drain(), org)
            _account_drops(org, thr)

    def _emit(self, mt: MessageType, sampled: list[FlowLogBatch], org: int) -> None:
        db = org_db(FLOW_LOG_DB, org)
        schema = self._schemas[mt]
        for batch in sampled:
            s0 = s1 = None
            if self.platform_state is not None:
                tags, valid, _n = _tags_for_enrich(batch)
                s0, s1, _keep, _drops = enrich_chunk_host(self.platform_state, tags, valid)
            cols = log_batch_to_columns(batch, s0, s1)
            self._writer(db, schema).put(cols)
            with self._lock:
                self.counters["rows_written"] += batch.size

    def flush(self):
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.flush()

    def stop(self, timeout: float = 5.0):
        self._running = False
        for qs in self.queues.values():
            for q in qs:
                q.close()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.stop()
