"""Server-side integration ingesters: ext_metrics (Telegraf/Influx +
self-telemetry dfstats), Prometheus remote-write, profiles, and OTel
spans — the ext_metrics / prometheus / profile ingester seats plus
flow_log's OTel decoder path.

Table shapes (the reference uses CK map columns + flow_tag sidecars for
dynamic tags; our store has fixed columns, so dynamic tags pack into a
sorted `k=v,k=v` string column with flow_tag rows recording the
dictionary — queryable by exact match or via the flow_tag catalog):

  ext_metrics.metrics        (time, virtual_table, tags, field_name, value)
  deepflow_stats.stats       (same shape — agent/self counters, DFSTATS)
  prometheus.samples         (time, metric, labels, value)
  profile.in_process_profile (time, app_service, stack, value)
  flow_log.l7_flow_log       (OTel spans — same table as packet L7 logs,
                              signal_source=OTEL)

Port copy of deepflow_tpu/server/integration.py.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..datamodel.code import L7Protocol, SignalSource
from ..flowlog.aggr import FlowLogBatch
from ..flowlog.schema import L7_FLOW_LOG
from ..flowlog.server import log_batch_to_columns, log_table_schema
from ..ingest.framing import HEADER_LEN, FlowHeader, MessageType, split_messages
from ..ingest.queues import new_queue
from ..ingest.receiver import Receiver
from ..integration.formats import (
    InfluxPoint,
    pack_tags,
    parse_folded,
    parse_influx_lines,
    parse_otlp_traces,
    parse_remote_write,
)
from ..storage.flow_tag import FlowTagWriter
from ..storage.store import ColumnarStore, ColumnSpec, TableSchema, org_db
from ..storage.writer import TableWriter
from ..utils.stats import register_countable

EXT_METRICS_SCHEMA = TableSchema(
    "metrics",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("virtual_table", "U64"),
        ColumnSpec("tags", "U512"),
        ColumnSpec("field_name", "U128"),
        ColumnSpec("value", "f8"),
    ),
)

PROM_SCHEMA = TableSchema(
    "samples",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("metric", "U128"),
        ColumnSpec("labels", "U512"),
        ColumnSpec("value", "f8"),
    ),
)

PROFILE_SCHEMA = TableSchema(
    "in_process_profile",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("app_service", "U128"),
        ColumnSpec("profile_event_type", "U32"),
        ColumnSpec("stack", "U2048"),
        ColumnSpec("value", "u8"),
    ),
)


class IntegrationIngester:
    """TELEGRAF / DFSTATS / PROMETHEUS / PROFILE / OPENTELEMETRY frames
    → storage tables, one worker per message type."""

    _TYPES = (
        MessageType.TELEGRAF,
        MessageType.DFSTATS,
        MessageType.SERVER_DFSTATS,
        MessageType.PROMETHEUS,
        MessageType.PROFILE,
        MessageType.OPENTELEMETRY,
        MessageType.OPENTELEMETRY_COMPRESSED,
        MessageType.SKYWALKING,
        MessageType.DATADOG,
    )

    def __init__(
        self,
        receiver: Receiver,
        store: ColumnarStore,
        *,
        queue_capacity: int = 1 << 13,
        writer_args: dict | None = None,
        trace_builder=None,  # tracing.TraceTreeBuilder | None
        prom_labels=None,  # default-org PrometheusLabelRegistry | None (enables SmartEncoding)
    ):
        self.store = store
        self.trace_builder = trace_builder
        self.prom_labels = prom_labels
        # id spaces are per-tenant: each org gets its own registry, loaded
        # from (and flushed into) its own prometheus db — sharing one
        # would leak label values across orgs and desync dictionaries
        self._prom_regs: dict[int, object] = {}
        self.writer_args = writer_args or {"flush_interval_s": 0.5}
        self._writers: dict[tuple[str, str], TableWriter] = {}
        self._flow_tags: dict[str, FlowTagWriter] = {}
        self._lock = threading.Lock()
        self.counters = {
            "frames_in": 0,
            "rows_written": 0,
            "decode_errors": 0,
        }
        self._running = True
        self._threads = []
        self.queues = {}
        for mt in self._TYPES:
            q = new_queue(queue_capacity, prefer_native=False)
            receiver.register_handler(mt, [q])
            self.queues[mt] = q
            t = threading.Thread(target=self._worker, args=(mt, q), daemon=True)
            t.start()
            self._threads.append(t)
        register_countable("integration_ingester", self)

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    def _writer(self, db: str, schema: TableSchema) -> TableWriter:
        with self._lock:
            w = self._writers.get((db, schema.name))
            if w is None:
                w = TableWriter(self.store, db, schema, **self.writer_args)
                self._writers[(db, schema.name)] = w
            return w

    def _flow_tag(self, db: str) -> FlowTagWriter:
        with self._lock:
            ft = self._flow_tags.get(db)
            if ft is None:
                ft = self._flow_tags[db] = FlowTagWriter(self.store, f"{db}_flow_tag")
            return ft

    # -- workers --------------------------------------------------------
    def _worker(self, mt: MessageType, q) -> None:
        while self._running:
            frames = q.gets(64, timeout_ms=100)
            for raw in frames:
                try:
                    header = FlowHeader.parse(raw[:HEADER_LEN])
                    msgs = split_messages(raw[HEADER_LEN:])
                except ValueError:
                    with self._lock:
                        self.counters["decode_errors"] += 1
                    continue
                with self._lock:
                    self.counters["frames_in"] += 1
                for msg in msgs:
                    self._dispatch(mt, header, msg)

    def _dispatch(self, mt: MessageType, header: FlowHeader, msg: bytes) -> None:
        org = header.organization_id
        try:
            if mt == MessageType.TELEGRAF:
                self._influx(org, "ext_metrics", msg)
            elif mt in (MessageType.DFSTATS, MessageType.SERVER_DFSTATS):
                self._influx(org, "deepflow_stats", msg)
            elif mt == MessageType.PROMETHEUS:
                self._prometheus(org, msg)
            elif mt == MessageType.PROFILE:
                self._profile(org, msg)
            elif mt == MessageType.OPENTELEMETRY:
                self._otel(org, header, msg)
            elif mt == MessageType.SKYWALKING:
                self._skywalking(org, header, msg)
            elif mt == MessageType.DATADOG:
                self._datadog(org, header, msg)
            elif mt == MessageType.OPENTELEMETRY_COMPRESSED:
                # agent-side zlib over the OTLP body (decoder.go:244
                # decodeOTelCompressed); bounded via the shared zip-bomb
                # guard in framing.decompress_body
                from ..ingest.framing import ENCODER_DEFLATE, decompress_body

                self._otel(org, header, decompress_body(msg, ENCODER_DEFLATE))
        except Exception:
            with self._lock:
                self.counters["decode_errors"] += 1

    def _influx(self, org: int, base_db: str, msg: bytes) -> None:
        points, errors = parse_influx_lines(msg.decode(errors="replace"))
        with self._lock:
            self.counters["decode_errors"] += errors
        if not points:
            return
        db = org_db(base_db, org)
        rows = {"time": [], "virtual_table": [], "tags": [], "field_name": [], "value": []}
        # timestamp-less lines get receipt time (line-protocol spec: the
        # server assigns its clock) — epoch 0 would hide them from every
        # time-ranged scan
        now_fallback = int(time.time())
        tag_catalog: dict[str, dict[str, dict[str, int]]] = {}
        for p in points:
            sec = p.timestamp_ns // 1_000_000_000 if p.timestamp_ns else now_fallback
            packed = pack_tags(p.tags)
            for fname, val in p.fields.items():
                rows["time"].append(sec)
                rows["virtual_table"].append(p.measurement)
                rows["tags"].append(packed)
                rows["field_name"].append(fname)
                rows["value"].append(val)
            cat = tag_catalog.setdefault(p.measurement, {})
            for k, v in p.tags.items():
                cat.setdefault(k, {})[v] = cat.get(k, {}).get(v, 0) + 1
        schema = EXT_METRICS_SCHEMA if base_db == "ext_metrics" else TableSchema(
            "stats", EXT_METRICS_SCHEMA.columns
        )
        n = len(rows["time"])
        self._writer(db, schema).put(
            {
                "time": np.asarray(rows["time"], np.uint32),
                "virtual_table": np.asarray(rows["virtual_table"]),
                "tags": np.asarray(rows["tags"]),
                "field_name": np.asarray(rows["field_name"]),
                "value": np.asarray(rows["value"], np.float64),
            }
        )
        ft = self._flow_tag(db)
        for table, fields in tag_catalog.items():
            ft.write(int(rows["time"][0]), table, fields)
        with self._lock:
            self.counters["rows_written"] += n

    def _prom_reg(self, org: int):
        from ..storage.store import DEFAULT_ORG_ID

        if org in (0, DEFAULT_ORG_ID):
            return self.prom_labels
        reg = self._prom_regs.get(org)
        if reg is None:
            from ..controller.prom_labels import PrometheusLabelRegistry

            reg = self._prom_regs[org] = PrometheusLabelRegistry.load(
                self.store, db=org_db("prometheus", org)
            )
        return reg

    def _prometheus(self, org: int, msg: bytes) -> None:
        series = parse_remote_write(msg)
        if not series:
            return
        rows = {"time": [], "metric": [], "labels": [], "value": []}
        for s in series:
            name = s.labels.get("__name__", "")
            packed = pack_tags({k: v for k, v in s.labels.items() if k != "__name__"})
            for ts_ms, val in s.samples:
                rows["time"].append(ts_ms // 1000)
                rows["metric"].append(name)
                rows["labels"].append(packed)
                rows["value"].append(val)
        self._writer(org_db("prometheus", org), PROM_SCHEMA).put(
            {
                "time": np.asarray(rows["time"], np.uint32),
                "metric": np.asarray(rows["metric"]),
                "labels": np.asarray(rows["labels"]),
                "value": np.asarray(rows["value"], np.float64),
            }
        )
        if self.prom_labels is not None:
            # SmartEncoding lane (grpc_label_ids.go seat): id-encoded
            # samples + dictionary sidecars, alongside the string table
            from ..controller.prom_labels import SAMPLES_ENC

            reg = self._prom_reg(org)
            enc_rows = {"time": [], "metric_id": [], "label_ids": [], "value": []}
            for s in series:
                mid, packed_ids = reg.encode(s.labels)
                for ts_ms, val in s.samples:
                    enc_rows["time"].append(ts_ms // 1000)
                    enc_rows["metric_id"].append(mid)
                    enc_rows["label_ids"].append(packed_ids)
                    enc_rows["value"].append(val)
            self._writer(org_db("prometheus", org), SAMPLES_ENC).put(
                {
                    "time": np.asarray(enc_rows["time"], np.uint32),
                    "metric_id": np.asarray(enc_rows["metric_id"], np.uint32),
                    "label_ids": np.asarray(enc_rows["label_ids"]),
                    "value": np.asarray(enc_rows["value"], np.float64),
                }
            )
            reg.flush_dicts(
                self.store, db=org_db("prometheus", org),
                now=int(rows["time"][0]) if rows["time"] else 0,
            )
        with self._lock:
            self.counters["rows_written"] += len(rows["time"])

    def _profile(self, org: int, msg: bytes) -> None:
        # msg: "service\x00event_type\x00timestamp_s\n" header + folded body
        head, _, body = msg.decode(errors="replace").partition("\n")
        service, _, rest = head.partition("\x00")
        event_type, _, ts_s = rest.partition("\x00")
        samples, errors = parse_folded(body)
        with self._lock:
            self.counters["decode_errors"] += errors
        if not samples:
            return
        sec = int(ts_s or 0)
        self._writer(org_db("profile", org), PROFILE_SCHEMA).put(
            {
                "time": np.full(len(samples), sec, np.uint32),
                "app_service": np.full(len(samples), service),
                "profile_event_type": np.full(len(samples), event_type or "cpu"),
                "stack": np.asarray([s.stack for s in samples]),
                "value": np.asarray([s.value for s in samples], np.uint64),
            }
        )
        with self._lock:
            self.counters["rows_written"] += len(samples)

    def _otel(self, org: int, header: FlowHeader, msg: bytes) -> None:
        self._spans(org, header, parse_otlp_traces(msg))

    def _skywalking(self, org: int, header: FlowHeader, msg: bytes) -> None:
        from ..integration.trace_imports import parse_skywalking_segment

        self._spans(org, header, parse_skywalking_segment(msg))

    def _datadog(self, org: int, header: FlowHeader, msg: bytes) -> None:
        from ..integration.trace_imports import parse_datadog_traces

        self._spans(org, header, parse_datadog_traces(msg))

    def _spans(self, org: int, header: FlowHeader, spans) -> None:
        """OtelSpan list → l7_flow_log rows + trace-tree observation —
        one lane shared by the OTLP / SkyWalking / Datadog imports
        (decoder.go:244/:289/:338 all converge on L7FlowLog the same way)."""
        if not spans:
            return
        s = L7_FLOW_LOG
        n = len(spans)
        ints = np.zeros((n, len(s.ints)), np.uint32)
        nums = np.zeros((n, len(s.nums)), np.float32)
        strs = {f.name: [""] * n for f in s.strs}
        ii = s.int_index
        for r, sp in enumerate(spans):
            ints[r, ii("agent_id")] = header.agent_id
            ints[r, ii("signal_source")] = int(SignalSource.OTEL)
            ints[r, ii("l7_protocol")] = int(
                L7Protocol.HTTP1 if sp.attributes.get("http.method") else L7Protocol.OTHER
            )
            ints[r, ii("type")] = 2
            ints[r, ii("tap_side")] = 49 if sp.kind == 3 else 50  # c-app / s-app
            ints[r, ii("start_time")] = sp.start_us // 1_000_000
            ints[r, ii("end_time")] = sp.end_us // 1_000_000
            ints[r, ii("response_duration")] = max(0, sp.end_us - sp.start_us)
            ints[r, ii("status")] = 4 if sp.status_code == 2 else 1
            code = sp.attributes.get("http.status_code", "")
            ints[r, ii("status_code")] = int(code) if code.isdigit() else 0
            strs["app_service"][r] = sp.service
            strs["endpoint"][r] = sp.name
            strs["request_type"][r] = sp.attributes.get("http.method", "")
            strs["request_resource"][r] = sp.attributes.get("http.target", sp.name)
            strs["request_domain"][r] = sp.attributes.get("http.host", "")
            strs["trace_id"][r] = sp.trace_id
            strs["span_id"][r] = sp.span_id
            strs["parent_span_id"][r] = sp.parent_span_id
            strs["x_request_id"][r] = sp.attributes.get(
                "http.request.header.x_request_id",
                sp.attributes.get("x_request_id", ""),
            )
        batch = FlowLogBatch(s, ints, nums, np.ones(n, bool), strs)
        db = org_db("flow_log", org)
        w = self._writer(db, log_table_schema(s))
        w.put(log_batch_to_columns(batch))
        with self._lock:
            self.counters["rows_written"] += n
        if self.trace_builder is not None:
            from ..tracing.tree import SpanRow

            self.trace_builder.observe(
                [
                    SpanRow(
                        trace_id=sp.trace_id,
                        span_id=sp.span_id,
                        parent_span_id=sp.parent_span_id,
                        app_service=sp.service,
                        tap_side=int(ints[r, ii("tap_side")]),
                        start_us=sp.start_us,
                        end_us=sp.end_us,
                        response_duration_us=max(0, sp.end_us - sp.start_us),
                        server_error=sp.status_code == 2,
                    )
                    for r, sp in enumerate(spans)
                ],
                org=org,
            )

    # -- lifecycle ------------------------------------------------------
    def flush(self):
        with self._lock:
            writers = list(self._writers.values())
            fts = list(self._flow_tags.values())
        for w in writers:
            w.flush()
        for ft in fts:
            ft.flush()

    def stop(self, timeout: float = 5.0):
        self._running = False
        for q in self.queues.values():
            q.close()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.stop()
