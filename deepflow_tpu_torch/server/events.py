"""event + app_log + pcap ingesters — the three remaining ingest seats.

Reference pipelines:
  * event: resource-change / proc / K8s / alert events → `event` db
    (server/ingester/event/{decoder,dbwriter}; EventStore row model
    event/dbwriter/event.go:54-100).
  * app_log: application logs (syslog / OTel logs) → `application_log`
    db (server/ingester/app_log/dbwriter/log.go:63-100).
  * pcap: policy-triggered raw packet batches → `pcap` db
    (server/ingester/pcap/).

Wire format deviation (documented): the reference carries these as
protobuf (eventapi / app_log pb); this build's control-ish planes are
JSON messages inside the standard 19-byte framed transport — same
framing, same queue fanout, same org routing, simpler codec. The pcap
plane is binary: [flow_id u64][ts_us u64][pkt_len u32][pkt bytes].

Port copy of deepflow_tpu/server/events.py.
"""

from __future__ import annotations

import json
import struct
import threading

import numpy as np

from ..ingest.framing import HEADER_LEN, FlowHeader, MessageType, split_messages
from ..ingest.queues import new_queue
from ..ingest.receiver import Receiver
from ..storage.store import ColumnarStore, ColumnSpec, TableSchema, org_db
from ..storage.writer import TableWriter
from ..utils.stats import register_countable

EVENT_SCHEMA = TableSchema(
    "event",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("start_time", "u8"),  # µs
        ColumnSpec("end_time", "u8"),  # µs
        ColumnSpec("signal_source", "u4"),
        ColumnSpec("event_type", "U64"),
        ColumnSpec("event_description", "U1024"),
        ColumnSpec("process_kname", "U128"),
        ColumnSpec("gprocess_id", "u4"),
        ColumnSpec("agent_id", "u4"),
        ColumnSpec("pod_id", "u4"),
        ColumnSpec("l3_epc_id", "u4"),
        ColumnSpec("resource_type", "U64"),
        ColumnSpec("resource_id", "u4"),
        ColumnSpec("resource_name", "U256"),
    ),
)

ALERT_SCHEMA = TableSchema(
    "alert_event",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("policy_id", "u4"),
        ColumnSpec("policy_name", "U256"),
        ColumnSpec("level", "u4"),  # 1 info / 2 warn / 3 error / 4 critical
        ColumnSpec("target_tags", "U1024"),
        ColumnSpec("metric_value", "f8"),
        ColumnSpec("event_description", "U1024"),
    ),
)

APP_LOG_SCHEMA = TableSchema(
    "log",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("timestamp_us", "u8"),
        ColumnSpec("agent_id", "u4"),
        ColumnSpec("app_service", "U128"),
        ColumnSpec("severity_number", "u4"),
        ColumnSpec("severity_text", "U16"),
        ColumnSpec("body", "U4096"),
        ColumnSpec("trace_id", "U64"),
        ColumnSpec("span_id", "U32"),
        ColumnSpec("attributes", "U1024"),
    ),
)

# per-packet TCP sequence records (flow_log decoder's l4_packet lane,
# decoder.go:387; log_data/l4_packet.go row model condensed). Wire:
# back-to-back 28-byte records [flow_id u64][ts_us u64][seq u32][ack u32]
# [payload_len u16][tcp_flags u8][direction u8].
L4_PACKET_SCHEMA = TableSchema(
    "l4_packet",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("agent_id", "u4"),
        ColumnSpec("flow_id_hi", "u4"),
        ColumnSpec("flow_id_lo", "u4"),
        ColumnSpec("ts_us", "u8"),
        ColumnSpec("seq", "u4"),
        ColumnSpec("ack", "u4"),
        ColumnSpec("payload_len", "u4"),
        ColumnSpec("tcp_flags", "u4"),
        ColumnSpec("direction", "u4"),
    ),
)

PCAP_SCHEMA = TableSchema(
    "pcap",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("agent_id", "u4"),
        ColumnSpec("flow_id_hi", "u4"),
        ColumnSpec("flow_id_lo", "u4"),
        ColumnSpec("ts_us", "u8"),
        ColumnSpec("packet_len", "u4"),
        ColumnSpec("packet", "U4096"),  # hex-encoded capture bytes
    ),
)

_SEVERITIES = {"trace": 1, "debug": 5, "info": 9, "warn": 13, "error": 17, "fatal": 21}


class EventIngester:
    """PROC_EVENT / K8S_EVENT / ALERT_EVENT / APPLICATION_LOG / RAW_PCAP
    frames → event / application_log / pcap databases."""

    _TYPES = (
        MessageType.PROC_EVENT,
        MessageType.K8S_EVENT,
        MessageType.ALERT_EVENT,
        MessageType.APPLICATION_LOG,
        MessageType.RAW_PCAP,
        MessageType.PACKETSEQUENCE,
        MessageType.SYSLOG,
        MessageType.AGENT_LOG,
    )

    def __init__(
        self,
        receiver: Receiver,
        store: ColumnarStore,
        *,
        queue_capacity: int = 1 << 12,
        writer_args: dict | None = None,
        max_pcap_bytes: int = 2048,
    ):
        self.store = store
        self.writer_args = writer_args or {"flush_interval_s": 0.5}
        self.max_pcap_bytes = max_pcap_bytes
        self._writers: dict[tuple[str, str], TableWriter] = {}
        self._lock = threading.Lock()
        self.counters = {"frames_in": 0, "rows_written": 0, "decode_errors": 0}
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
        register_countable("event_ingester", self)

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
                    try:
                        self._dispatch(mt, header, msg)
                    except Exception:
                        with self._lock:
                            self.counters["decode_errors"] += 1

    def _dispatch(self, mt: MessageType, header: FlowHeader, msg: bytes) -> None:
        org = header.organization_id
        if mt in (MessageType.PROC_EVENT, MessageType.K8S_EVENT):
            self._event(org, header, msg, mt)
        elif mt == MessageType.ALERT_EVENT:
            self._alert(org, msg)
        elif mt == MessageType.APPLICATION_LOG:
            self._app_log(org, header, msg)
        elif mt == MessageType.RAW_PCAP:
            self._pcap(org, header, msg)
        elif mt == MessageType.PACKETSEQUENCE:
            self._l4_packet(org, header, msg)
        elif mt in (MessageType.SYSLOG, MessageType.AGENT_LOG):
            self._syslog(org, header, msg, mt)

    def _event(self, org: int, header: FlowHeader, msg: bytes, mt) -> None:
        ev = json.loads(msg)
        sig = 1 if mt == MessageType.PROC_EVENT else 2  # proc / k8s
        start = int(ev.get("start_time_us") or 0)
        self._writer(org_db("event", org), EVENT_SCHEMA).put(
            {
                "time": np.array([ev.get("time") or start // 1_000_000], np.uint32),
                "start_time": np.array([start], np.uint64),
                "end_time": np.array([int(ev.get("end_time_us") or start)], np.uint64),
                "signal_source": np.array([int(ev.get("signal_source") or sig)], np.uint32),
                "event_type": np.array([str(ev.get("event_type", ""))]),
                "event_description": np.array([str(ev.get("description", ""))]),
                "process_kname": np.array([str(ev.get("process_kname", ""))]),
                "gprocess_id": np.array([int(ev.get("gprocess_id") or 0)], np.uint32),
                "agent_id": np.array([header.agent_id], np.uint32),
                "pod_id": np.array([int(ev.get("pod_id") or 0)], np.uint32),
                "l3_epc_id": np.array([int(ev.get("l3_epc_id") or 0) & 0xFFFFFFFF], np.uint32),
                "resource_type": np.array([str(ev.get("resource_type", ""))]),
                "resource_id": np.array([int(ev.get("resource_id") or 0)], np.uint32),
                "resource_name": np.array([str(ev.get("resource_name", ""))]),
            }
        )
        with self._lock:
            self.counters["rows_written"] += 1

    def _alert(self, org: int, msg: bytes) -> None:
        ev = json.loads(msg)
        self._writer(org_db("event", org), ALERT_SCHEMA).put(
            {
                "time": np.array([int(ev.get("time") or 0)], np.uint32),
                "policy_id": np.array([int(ev.get("policy_id") or 0)], np.uint32),
                "policy_name": np.array([str(ev.get("policy_name", ""))]),
                "level": np.array([int(ev.get("level") or 1)], np.uint32),
                "target_tags": np.array([json.dumps(ev.get("target_tags", {}), sort_keys=True)]),
                "metric_value": np.array([float(ev.get("metric_value") or 0.0)]),
                "event_description": np.array([str(ev.get("description", ""))]),
            }
        )
        with self._lock:
            self.counters["rows_written"] += 1

    def _app_log(self, org: int, header: FlowHeader, msg: bytes) -> None:
        ev = json.loads(msg)
        ts_us = int(ev.get("timestamp_us") or 0)
        sev_text = str(ev.get("severity_text", "")).lower()
        sev = int(ev.get("severity_number") or _SEVERITIES.get(sev_text, 0))
        self._writer(org_db("application_log", org), APP_LOG_SCHEMA).put(
            {
                "time": np.array([ev.get("time") or ts_us // 1_000_000], np.uint32),
                "timestamp_us": np.array([ts_us], np.uint64),
                "agent_id": np.array([header.agent_id], np.uint32),
                "app_service": np.array([str(ev.get("app_service", ""))]),
                "severity_number": np.array([sev], np.uint32),
                "severity_text": np.array([sev_text]),
                "body": np.array([str(ev.get("body", ""))]),
                "trace_id": np.array([str(ev.get("trace_id", ""))]),
                "span_id": np.array([str(ev.get("span_id", ""))]),
                "attributes": np.array([json.dumps(ev.get("attributes", {}), sort_keys=True)]),
            }
        )
        with self._lock:
            self.counters["rows_written"] += 1

    # RFC 5424 severity (0=emergency … 7=debug) → (OTel severity_number,
    # text). The application_log column is OTel-scaled (higher = worse,
    # _SEVERITIES writes info=9/error=17), so syslog levels must be
    # translated onto that scale or filters/sorts interleave two
    # opposite-direction scales in one table.
    _SYSLOG_SEV = {
        0: (24, "emergency"), 1: (22, "alert"), 2: (21, "critical"),
        3: (17, "error"), 4: (13, "warning"), 5: (10, "notice"),
        6: (9, "info"), 7: (5, "debug"),
    }

    @staticmethod
    def _syslog_timestamp(line: str) -> tuple[int, str]:
        """Extract an event timestamp from an RFC 5424 line head
        ("1 2026-07-30T06:12:33.5Z host …"). Returns (ts_us,
        remaining_line) — (0, line) when no tz-qualified time leads the
        message; buffered 5424 lines re-shipped after an outage keep
        their event time instead of the ingest time."""
        import datetime as _dt
        import re as _re

        m = _re.match(r"1 (\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(?:\.\d+)?)(Z|[+-]\d{2}:\d{2})?\s*", line)
        if m:
            try:
                iso = m.group(1)
                if "." in iso:
                    # py3.10 fromisoformat only takes 3/6-digit fractions
                    head, frac = iso.split(".")
                    iso = head + "." + frac[:6].ljust(6, "0")
                iso += (m.group(2) or "+00:00").replace("Z", "+00:00")
                dt = _dt.datetime.fromisoformat(iso)
                return int(dt.timestamp() * 1_000_000), line[m.end():]
            except ValueError:
                return 0, line
        # RFC 3164 heads ("Jul 30 06:12:33") carry no timezone, so the
        # instant is ambiguous by the sender's UTC offset — worse than
        # ingest time. Leave them in the body and let the caller stamp
        # ingest time; only tz-qualified 5424 timestamps are trusted.
        return 0, line

    def _syslog(self, org: int, header: FlowHeader, msg: bytes, mt) -> None:
        """SYSLOG / AGENT_LOG frames → application_log rows.

        The reference routes agent-forwarded syslog and the agent's own
        log stream to the server (droplet-message TYPE_SYSLOG /
        AGENT_LOG); here both land in the same application_log table the
        OTel/app-log lane writes, tagged by source. Payload is the raw
        text line, optionally RFC 3164/5424 "<PRI>" prefixed; ts comes
        from the frame when no structured time is present."""
        import time as _time

        line = msg.decode(errors="replace").rstrip("\n")
        syslog_sev = 6  # info default
        if line.startswith("<"):
            end = line.find(">", 1, 6)
            if end > 0 and line[1:end].isdigit():
                syslog_sev = int(line[1:end]) & 0x7
                line = line[end + 1 :]
        sev_num, sev_text = self._SYSLOG_SEV[syslog_sev]
        svc = "syslog" if mt == MessageType.SYSLOG else "deepflow-agent"
        ts_us, line = self._syslog_timestamp(line)
        if ts_us == 0:  # no structured time in the payload
            ts_us = int(_time.time() * 1_000_000)
        self._writer(org_db("application_log", org), APP_LOG_SCHEMA).put(
            {
                "time": np.array([ts_us // 1_000_000], np.uint32),
                "timestamp_us": np.array([ts_us], np.uint64),
                "agent_id": np.array([header.agent_id], np.uint32),
                "app_service": np.array([svc]),
                "severity_number": np.array([sev_num], np.uint32),
                "severity_text": np.array([sev_text]),
                "body": np.array([line]),
                "trace_id": np.array([""]),
                "span_id": np.array([""]),
                "attributes": np.array(["{}"]),
            }
        )
        with self._lock:
            self.counters["rows_written"] += 1

    def _pcap(self, org: int, header: FlowHeader, msg: bytes) -> None:
        # [flow_id u64 BE][ts_us u64 BE][pkt_len u32 BE][pkt bytes]
        if len(msg) < 20:
            raise ValueError("short pcap record")
        flow_id, ts_us, pkt_len = struct.unpack_from(">QQI", msg, 0)
        pkt = msg[20 : 20 + min(pkt_len, self.max_pcap_bytes)]
        self._writer(org_db("pcap", org), PCAP_SCHEMA).put(
            {
                "time": np.array([ts_us // 1_000_000], np.uint32),
                "agent_id": np.array([header.agent_id], np.uint32),
                "flow_id_hi": np.array([flow_id >> 32], np.uint32),
                "flow_id_lo": np.array([flow_id & 0xFFFFFFFF], np.uint32),
                "ts_us": np.array([ts_us], np.uint64),
                "packet_len": np.array([pkt_len], np.uint32),
                "packet": np.array([pkt.hex()]),
            }
        )
        with self._lock:
            self.counters["rows_written"] += 1

    # 28-byte packet-sequence record; parsed as one structured-dtype
    # frombuffer — this is the highest-volume lane (one record per TCP
    # packet), a per-record unpack loop would dominate the worker
    _L4P_DT = np.dtype([
        ("fid", ">u8"), ("ts", ">u8"), ("seq", ">u4"), ("ack", ">u4"),
        ("plen", ">u2"), ("flags", "u1"), ("dir", "u1"),
    ])

    def _l4_packet(self, org: int, header: FlowHeader, msg: bytes) -> None:
        n = len(msg) // self._L4P_DT.itemsize
        if n == 0:
            raise ValueError("short l4_packet record")
        a = np.frombuffer(msg, dtype=self._L4P_DT, count=n)
        ts = a["ts"].astype(np.uint64)
        out = {
            "time": (ts // 1_000_000).astype(np.uint32),
            "agent_id": np.full(n, header.agent_id, np.uint32),
            "flow_id_hi": (a["fid"] >> np.uint64(32)).astype(np.uint32),
            "flow_id_lo": (a["fid"] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "ts_us": ts,
            "seq": a["seq"].astype(np.uint32),
            "ack": a["ack"].astype(np.uint32),
            "payload_len": a["plen"].astype(np.uint32),
            "tcp_flags": a["flags"].astype(np.uint32),
            "direction": a["dir"].astype(np.uint32),
        }
        self._writer(org_db("flow_log", org), L4_PACKET_SCHEMA).put(out)
        with self._lock:
            self.counters["rows_written"] += n

    # -- lifecycle ------------------------------------------------------
    def flush(self):
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.flush()

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
