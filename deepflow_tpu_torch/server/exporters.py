"""Universal export framework — the server/ingester/exporters seat.

The reference exports enriched telemetry to external sinks (Kafka /
OTLP / Prometheus remote-write) with per-exporter data-source filters
and universal-tag re-translation to strings (exporters/config,
universal_tag/). Same composition here: `Exporter` strategies receive
(table_name, columns) batches tapped off the ingest write path after
enrichment; the tag translator renders integer ids back to names so
sinks get self-describing records.

Sinks: JSONL file (the Kafka-topic stand-in — no broker in-image),
Prometheus remote-write POST (re-using our own encoder), and a callback
for embedding. Filters: table prefixes ("network", "application_map").

Port copy of deepflow_tpu/server/exporters.py.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from ..integration.formats import PromSeries, encode_remote_write
from ..utils.stats import register_countable

# tag columns re-translated to names when a translator is present
_TRANSLATED = ("pod_id_0", "pod_id_1", "auto_service_id_0", "auto_service_id_1", "region_id_0")


class Exporter:
    """Base: filter + counters; subclasses implement _send(rows)."""

    def __init__(self, *, data_sources: tuple[str, ...] = (), translator=None):
        self.data_sources = data_sources
        self.translator = translator
        self.counters = {"batches": 0, "rows": 0, "errors": 0, "filtered": 0}
        self._lock = threading.Lock()
        register_countable("exporter", self, sink=type(self).__name__)

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    def accepts(self, table: str) -> bool:
        return not self.data_sources or any(
            table.startswith(p) for p in self.data_sources
        )

    def export(self, table: str, cols: dict[str, np.ndarray]) -> None:
        if not self.accepts(table):
            with self._lock:
                self.counters["filtered"] += 1
            return
        rows = self._to_rows(table, cols)
        try:
            self._send(table, rows)
            with self._lock:
                self.counters["batches"] += 1
                self.counters["rows"] += len(rows)
        except Exception:
            with self._lock:
                self.counters["errors"] += 1

    def _to_rows(self, table: str, cols: dict[str, np.ndarray]) -> list[dict]:
        names = {}
        if self.translator is not None:
            for c in _TRANSLATED:
                if c in cols:
                    names[c.replace("_id", "_name").replace("pod_id", "pod_name")] = (
                        self.translator.translate(table, c, np.asarray(cols[c]))
                    )
        n = len(next(iter(cols.values()))) if cols else 0
        out = []
        for i in range(n):
            row = {k: _py(v[i]) for k, v in cols.items()}
            for k, v in names.items():
                row[k] = str(v[i])
            out.append(row)
        return out

    def _send(self, table: str, rows: list[dict]) -> None:
        raise NotImplementedError


def _py(v):
    return v.item() if hasattr(v, "item") else v


class FileExporter(Exporter):
    """JSONL sink — the Kafka-topic stand-in (one file per table)."""

    def __init__(self, directory: str | Path, **kw):
        super().__init__(**kw)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _send(self, table: str, rows: list[dict]) -> None:
        with open(self.directory / f"{table}.jsonl", "a") as f:
            for r in rows:
                f.write(json.dumps({"table": table, **r}) + "\n")


class CallbackExporter(Exporter):
    def __init__(self, fn, **kw):
        super().__init__(**kw)
        self.fn = fn

    def _send(self, table: str, rows: list[dict]) -> None:
        self.fn(table, rows)


class RemoteWriteExporter(Exporter):
    """Meter columns → Prometheus remote-write POSTs: one series per
    (metric column, table), labels from the translated tag columns."""

    def __init__(self, url: str, *, metrics: tuple[str, ...] = (), **kw):
        super().__init__(**kw)
        self.url = url
        self.metrics = metrics

    def _send(self, table: str, rows: list[dict]) -> None:
        series = []
        for row in rows:
            ts_ms = int(row.get("time", 0)) * 1000
            labels = {
                k: str(v)
                for k, v in row.items()
                if isinstance(v, str) and v and k != "time"
            }
            for m in self.metrics:
                if m in row:
                    series.append(
                        PromSeries(
                            {"__name__": f"deepflow_{table}_{m}", **labels},
                            [(ts_ms, float(row[m]))],
                        )
                    )
        if not series:
            return
        req = urllib.request.Request(
            self.url,
            data=encode_remote_write(series),
            headers={"Content-Type": "application/x-protobuf"},
        )
        urllib.request.urlopen(req, timeout=5).read()


# Tables whose rows are spans/logs, not metric documents — they must
# only ever reach the OTLP traces lane.
_TRACE_TABLES = ("l7_flow_log",)


class OtlpExporter(Exporter):
    """OTLP/HTTP protobuf sink (exporters/otlp_exporter/otlp_exporter.go).

    l7_flow_log rows → OTLP trace spans (ExportTraceServiceRequest) and
    metric-table rows → OTLP Sum/Gauge metrics, POSTed with
    Content-Type application/x-protobuf. Pointing `traces_url` at our
    own IntegrationCollector's /v1/traces closes the loop: exported
    spans re-ingest through the OTel lane (the round-trip test pins
    this)."""


    def __init__(self, traces_url: str = "", metrics_url: str = "", *,
                 metrics: tuple[str, ...] = (), **kw):
        kw.setdefault("data_sources", ("l7_flow_log", "network", "application"))
        super().__init__(**kw)
        self.traces_url = traces_url
        self.metrics_url = metrics_url
        self.metrics = metrics

    def _send(self, table: str, rows: list[dict]) -> None:
        from ..integration.formats import (
            OtelSpan,
            OtlpMetric,
            OtlpMetricPoint,
            encode_otlp_metrics,
            encode_otlp_traces,
        )

        if table in _TRACE_TABLES:
            # trace rows NEVER fall through to the metrics branch: with
            # metrics_url set but traces_url empty, l7_flow_log rows
            # used to be exported as bogus deepflow_l7_flow_log_*
            # metrics (ADVICE.md #4) — now they are skipped AND counted
            # (deepflow_stats `exporter.trace_rows_skipped`) until a
            # traces_url is configured, so the drop is observable.
            if self.traces_url:
                spans = [self._row_to_span(r) for r in rows]
                self._post(self.traces_url, encode_otlp_traces(spans))
            else:
                with self._lock:
                    self.counters["trace_rows_skipped"] = (
                        self.counters.get("trace_rows_skipped", 0) + len(rows)
                    )
        elif self.metrics_url and self.metrics:
            points: dict[str, list[OtlpMetricPoint]] = {}
            for r in rows:
                t_ns = int(r.get("time", 0)) * 1_000_000_000
                attrs = {k: str(v) for k, v in r.items()
                         if isinstance(v, str) and v and k != "time"}
                for m in self.metrics:
                    if m in r:
                        points.setdefault(m, []).append(
                            OtlpMetricPoint(attrs, t_ns, float(r[m]))
                        )
            from ..querier.metrics import metric_type

            # counters export as monotonic cumulative Sums, everything
            # else (delays, ratios, gauges, untyped) as Gauges
            ms = [
                OtlpMetric("deepflow", f"deepflow_{table}_{m}", "",
                           metric_type(table, m) == "counter", pts)
                for m, pts in points.items()
            ]
            if ms:
                self._post(self.metrics_url, encode_otlp_metrics(ms))

    @staticmethod
    def _row_to_span(r: dict):
        from ..datamodel.code import L7Protocol
        from ..integration.formats import OtelSpan

        tap_side = int(r.get("tap_side", 0) or 0)
        try:
            l7_name = L7Protocol(int(r.get("l7_protocol", 0) or 0)).name
        except ValueError:
            l7_name = str(r.get("l7_protocol", ""))
        attrs = {"df.capture.tap_side": str(tap_side),
                 "df.l7_protocol": l7_name}
        for col, attr in (
            ("request_type", "df.request_type"),
            ("request_domain", "df.request_domain"),
            ("request_resource", "df.request_resource"),
            ("endpoint", "df.endpoint"),
            ("x_request_id", "df.x_request_id"),
            ("response_exception", "df.response_exception"),
        ):
            v = r.get(col)
            if v:
                attrs[attr] = str(v)
        for col in ("status_code", "server_port", "pod_id_0", "pod_id_1",
                    "auto_service_id_0", "auto_service_id_1"):
            v = r.get(col)
            if v:
                attrs[f"df.{col}"] = str(v)
        start_us = int(r.get("start_time", 0) or 0) * 1_000_000
        end_us = start_us + int(r.get("response_duration", 0) or 0)
        status = int(r.get("status", 0) or 0)  # 1 ok / 3 client / 4 server err
        return OtelSpan(
            service=str(r.get("app_service") or "deepflow"),
            name=str(r.get("endpoint") or r.get("request_resource") or l7_name),
            trace_id=str(r.get("trace_id", "") or ""),
            span_id=str(r.get("span_id", "") or ""),
            parent_span_id=str(r.get("parent_span_id", "") or ""),
            # tap_side 1 = client-side capture → CLIENT(3), else SERVER(2)
            kind=3 if tap_side == 1 else 2,
            start_us=start_us,
            end_us=end_us,
            status_code=2 if status in (3, 4) else 1,
            attributes=attrs,
        )

    @staticmethod
    def _post(url: str, body: bytes) -> None:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/x-protobuf"}
        )
        urllib.request.urlopen(req, timeout=5).read()


class ExporterHub:
    """Fan one write-path tap into all configured exporters —
    asynchronously. The ingest hot path must never block on a sink (the
    reference feeds exporters through queues, unmarshaller.go:284); a
    slow/unreachable sink sheds batches here instead of stalling writes.
    """

    def __init__(self, exporters: list[Exporter], *, queue_size: int = 256):
        self.exporters = exporters
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.counters = {"dropped_full": 0}
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        register_countable("exporter_hub", self)

    def get_counters(self):
        return dict(self.counters)

    def export(self, table: str, cols: dict[str, np.ndarray]) -> None:
        try:
            self._q.put_nowait((table, cols))
        except queue.Full:
            self.counters["dropped_full"] += 1

    def _run(self) -> None:
        while self._running:
            try:
                table, cols = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            for e in self.exporters:
                e.export(table, cols)

    def flush(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def stop(self) -> None:
        self.flush()
        self._running = False
        self._thread.join(timeout=2)
