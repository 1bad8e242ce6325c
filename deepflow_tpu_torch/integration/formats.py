"""Wire-format decoders for integration telemetry.

Four formats, each hand-rolled and dependency-free like the rest of the
codec layer:

* InfluxDB line protocol (Telegraf) — `integration_collector.rs`
  forwards raw lines; the server's ext_metrics decoder parses them
  (server/ingester/ext_metrics/decoder.go).
* Prometheus remote-write WriteRequest protobuf (prometheus/decoder).
  Snappy framing is NOT implemented (no snappy in the image) — senders
  must use Content-Encoding: identity or gzip; the HTTP layer gates it.
* OTLP ExportTraceServiceRequest protobuf subset — enough of
  opentelemetry.proto.trace.v1 to build l7_flow_log span rows
  (flow_log/decoder.go:244 OTel path).
* Pyroscope "folded" stacks text (profile/decoder).

Port copy of deepflow_tpu/integration/formats.py. The packed dynamic-tag
strings (`pack_tags` / `unpack_tags`) are what the deepflow_system sinks
write and a label selector reads back.
"""

from __future__ import annotations

import dataclasses

from ..ingest.codec import (
    _get_varint,
    _iter_fields,
    _put_varint,
    pb_bytes as _pb_bytes,
    pb_fixed64 as _pb_fixed64,
    pb_str as _pb_str,
    pb_varint as _pb_varint,
)

# ---------------------------------------------------------------------------
# InfluxDB line protocol


@dataclasses.dataclass
class InfluxPoint:
    measurement: str
    tags: dict[str, str]
    fields: dict[str, float]
    timestamp_ns: int  # 0 = unset


def _split_escaped(s: str, sep: str) -> list[str]:
    out, cur, esc = [], [], False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def parse_influx_lines(text: str) -> tuple[list[InfluxPoint], int]:
    """→ (points, error_count). One bad line never kills the batch."""
    points, errors = [], 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            points.append(_parse_influx_line(line))
        except Exception:
            errors += 1
    return points, errors


def _parse_influx_line(line: str) -> InfluxPoint:
    # measurement[,tag=v...] field=v[,field=v...] [timestamp]
    # split on unescaped spaces into ≤3 parts
    parts, cur, esc, quoted = [], [], False, False
    for ch in line:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            quoted = not quoted
            cur.append(ch)
        elif ch == " " and not quoted and len(parts) < 2:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    if len(parts) < 2:
        raise ValueError("missing fields")
    head = _split_escaped(parts[0], ",")
    measurement = head[0]
    if not measurement:
        raise ValueError("empty measurement")
    tags = {}
    for t in head[1:]:
        k, _, v = t.partition("=")
        if k:
            tags[k] = v
    fields: dict[str, float] = {}
    for f in _split_escaped(parts[1], ","):
        k, _, v = f.partition("=")
        if not k or v == "":
            raise ValueError(f"bad field {f!r}")
        if v.startswith('"'):
            continue  # string fields are not numeric metrics
        if v.endswith(("i", "u")):
            fields[k] = float(int(v[:-1]))
        elif v in ("t", "T", "true", "True"):
            fields[k] = 1.0
        elif v in ("f", "F", "false", "False"):
            fields[k] = 0.0
        else:
            fields[k] = float(v)
    if not fields:
        raise ValueError("no numeric fields")
    ts = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return InfluxPoint(measurement, tags, fields, ts)


# ---------------------------------------------------------------------------
# packed dynamic-tag strings (the CK map-column stand-in): values may
# contain ',' '=' '\' — escape on pack, unescape on parse, one pair of
# functions shared by the ingesters and the PromQL evaluator


def pack_tags(tags: dict[str, str]) -> str:
    def esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace(",", "\\,").replace("=", "\\=")

    return ",".join(f"{esc(k)}={esc(v)}" for k, v in sorted(tags.items()))


def unpack_tags(packed: str) -> dict[str, str]:
    out: dict[str, str] = {}
    key, cur, esc_on = None, [], False
    for ch in packed:
        if esc_on:
            cur.append(ch)
            esc_on = False
        elif ch == "\\":
            esc_on = True
        elif ch == "=" and key is None:
            key = "".join(cur)
            cur = []
        elif ch == ",":
            if key is not None:
                out[key] = "".join(cur)
            key, cur = None, []
        else:
            cur.append(ch)
    if key is not None:
        out[key] = "".join(cur)
    return out


# ---------------------------------------------------------------------------
# Prometheus remote-write protobuf (prompb.WriteRequest)


@dataclasses.dataclass
class PromSeries:
    labels: dict[str, str]  # includes __name__
    samples: list[tuple[int, float]]  # (timestamp_ms, value)


def parse_remote_write(body: bytes) -> list[PromSeries]:
    """prompb: WriteRequest{timeseries=1}; TimeSeries{labels=1 Label
    {name=1,value=2}, samples=2 Sample{value=1 double, timestamp=2}}."""
    import struct

    series = []
    for field, ts_bytes in _iter_fields(body):
        if field != 1 or not isinstance(ts_bytes, (bytes, bytearray)):
            continue
        labels: dict[str, str] = {}
        samples: list[tuple[int, float]] = []
        for f2, v2 in _iter_fields(bytes(ts_bytes)):
            if f2 == 1 and isinstance(v2, (bytes, bytearray)):
                name = value = ""
                for f3, v3 in _iter_fields(bytes(v2)):
                    if f3 == 1:
                        name = bytes(v3).decode(errors="replace")
                    elif f3 == 2:
                        value = bytes(v3).decode(errors="replace")
                if name:
                    labels[name] = value
            elif f2 == 2 and isinstance(v2, (bytes, bytearray)):
                val = 0.0
                ts = 0
                for f3, v3 in _iter_fields(bytes(v2)):
                    if f3 == 1:  # fixed64 double
                        val = struct.unpack("<d", int(v3).to_bytes(8, "little"))[0]
                    elif f3 == 2:
                        ts = _zigzag_free_i64(v3)
                samples.append((ts, val))
        if labels:
            series.append(PromSeries(labels, samples))
    return series


def _zigzag_free_i64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def encode_remote_write(series: list[PromSeries]) -> bytes:
    """Test/SDK-side encoder for the same subset."""
    import struct

    from ..ingest.codec import _put_varint

    out = bytearray()
    for s in series:
        ts_buf = bytearray()
        for name, value in s.labels.items():
            lb = bytearray()
            _put_varint(lb, 1 << 3 | 2)
            _put_varint(lb, len(name.encode()))
            lb += name.encode()
            _put_varint(lb, 2 << 3 | 2)
            _put_varint(lb, len(value.encode()))
            lb += value.encode()
            _put_varint(ts_buf, 1 << 3 | 2)
            _put_varint(ts_buf, len(lb))
            ts_buf += lb
        for ts, val in s.samples:
            sb = bytearray()
            _put_varint(sb, 1 << 3 | 1)  # fixed64
            sb += struct.pack("<d", val)
            _put_varint(sb, 2 << 3 | 0)
            _put_varint(sb, ts & ((1 << 64) - 1))
            _put_varint(ts_buf, 2 << 3 | 2)
            _put_varint(ts_buf, len(sb))
            ts_buf += sb
        _put_varint(out, 1 << 3 | 2)
        _put_varint(out, len(ts_buf))
        out += ts_buf
    return bytes(out)


# ---------------------------------------------------------------------------
# OTLP trace protobuf subset


@dataclasses.dataclass
class OtelSpan:
    service: str
    name: str
    trace_id: str
    span_id: str
    parent_span_id: str
    kind: int  # 2=server, 3=client
    start_us: int
    end_us: int
    status_code: int  # 0 unset, 1 ok, 2 error
    attributes: dict[str, str]


def _any_value(buf: bytes) -> str:
    for f, v in _iter_fields(buf):
        if f == 1:
            return bytes(v).decode(errors="replace")
        if f == 2:
            return "true" if v else "false"
        if f == 3:
            return str(_zigzag_free_i64(v))
        if f == 4:
            import struct

            return str(struct.unpack("<d", int(v).to_bytes(8, "little"))[0])
    return ""


def _attributes(buf_list: list[bytes]) -> dict[str, str]:
    out = {}
    for kv in buf_list:
        key, val = "", ""
        try:
            for f, v in _iter_fields(kv):
                if f == 1:
                    key = bytes(v).decode(errors="replace")
                elif f == 2:
                    val = _any_value(bytes(v))
        except Exception:
            continue
        if key:
            out[key] = val
    return out


def parse_otlp_traces(body: bytes) -> list[OtelSpan]:
    """Malformed sub-messages are skipped, never raised — ingest frames
    are untrusted."""
    spans: list[OtelSpan] = []
    try:
        resource_spans = [bytes(v) for f, v in _iter_fields(body) if f == 1]
    except Exception:
        return spans
    for rs in resource_spans:
        service = ""
        scope_spans = []
        try:
            for f2, v2 in _iter_fields(rs):
                if f2 == 1:  # resource
                    attrs = [bytes(v3) for f3, v3 in _iter_fields(bytes(v2)) if f3 == 1]
                    service = _attributes(attrs).get("service.name", "")
                elif f2 == 2:
                    scope_spans.append(bytes(v2))
        except Exception:
            continue
        for ss in scope_spans:
            try:
                span_bufs = [bytes(v) for f, v in _iter_fields(ss) if f == 2]
            except Exception:
                continue
            for sb in span_bufs:
                s = _parse_span(service, sb)
                if s is not None:
                    spans.append(s)
    return spans


def _parse_span(service: str, buf: bytes) -> OtelSpan | None:
    s = OtelSpan(service, "", "", "", "", 0, 0, 0, 0, {})
    attrs = []
    try:
        for f3, v3 in _iter_fields(buf):
            if f3 == 1:
                s.trace_id = bytes(v3).hex()
            elif f3 == 2:
                s.span_id = bytes(v3).hex()
            elif f3 == 4:
                s.parent_span_id = bytes(v3).hex()
            elif f3 == 5:
                s.name = bytes(v3).decode(errors="replace")
            elif f3 == 6:
                s.kind = int(v3)
            elif f3 == 7:
                s.start_us = int(v3) // 1000
            elif f3 == 8:
                s.end_us = int(v3) // 1000
            elif f3 == 9:
                attrs.append(bytes(v3))
            elif f3 == 15:
                # Status: field 2 is `message` (string), field 3 is `code`
                # (opentelemetry/proto/trace/v1/trace.proto Status)
                for f4, v4 in _iter_fields(bytes(v3)):
                    if f4 == 3:
                        s.status_code = int(v4)
        s.attributes = _attributes(attrs)
        return s
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Pyroscope folded stacks


@dataclasses.dataclass
class ProfileSample:
    stack: str  # "a;b;c"
    value: int


def parse_folded(text: str) -> tuple[list[ProfileSample], int]:
    out, errors = [], 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, v = line.rpartition(" ")
        try:
            out.append(ProfileSample(stack, int(v)))
        except ValueError:
            errors += 1
    return out, errors


# ---------------------------------------------------------------------------
# OTLP encoders — the export half of the subsets parsed above
# (exporters/otlp_exporter/otlp_exporter.go builds the same messages via
# the generated SDK; here the encoder is the byte-level inverse of
# parse_otlp_traces / parse_otlp_metrics so round-trips are testable).


def _kv_str(key: str, value: str) -> bytes:
    av = bytearray()
    _pb_str(av, 1, value)  # AnyValue.string_value
    kv = bytearray()
    _pb_str(kv, 1, key)
    _pb_bytes(kv, 2, bytes(av))
    return bytes(kv)


def _resource_block(service: str) -> bytes:
    res = bytearray()
    _pb_bytes(res, 1, _kv_str("service.name", service))  # Resource.attributes
    return bytes(res)


def _hex_bytes(s: str) -> bytes:
    s = (s or "").strip()
    if len(s) % 2:
        s = "0" + s
    try:
        return bytes.fromhex(s)
    except ValueError:
        return b""


def encode_otlp_traces(spans: list[OtelSpan]) -> bytes:
    """OtelSpan rows → ExportTraceServiceRequest bytes (grouped by
    service into one ResourceSpans each)."""
    by_service: dict[str, list[OtelSpan]] = {}
    for s in spans:
        by_service.setdefault(s.service, []).append(s)
    out = bytearray()
    for service, group in by_service.items():
        ss = bytearray()  # ScopeSpans
        for s in group:
            sp = bytearray()
            _pb_bytes(sp, 1, _hex_bytes(s.trace_id))
            _pb_bytes(sp, 2, _hex_bytes(s.span_id))
            if s.parent_span_id:
                _pb_bytes(sp, 4, _hex_bytes(s.parent_span_id))
            _pb_str(sp, 5, s.name)
            if s.kind:
                _pb_varint(sp, 6, s.kind)
            _pb_fixed64(sp, 7, s.start_us * 1000)
            _pb_fixed64(sp, 8, s.end_us * 1000)
            for k, v in s.attributes.items():
                _pb_bytes(sp, 9, _kv_str(k, str(v)))
            if s.status_code:
                st = bytearray()
                _pb_varint(st, 3, s.status_code)
                _pb_bytes(sp, 15, bytes(st))
            _pb_bytes(ss, 2, bytes(sp))  # ScopeSpans.spans
        rs = bytearray()
        _pb_bytes(rs, 1, _resource_block(service))
        _pb_bytes(rs, 2, bytes(ss))  # ResourceSpans.scope_spans
        out2 = bytearray()
        _pb_bytes(out2, 1, bytes(rs))
        out += out2
    return bytes(out)


@dataclasses.dataclass
class OtlpMetricPoint:
    attributes: dict[str, str]
    time_ns: int
    value: float


@dataclasses.dataclass
class OtlpMetric:
    service: str
    name: str
    unit: str
    monotonic: bool  # True → Sum (cumulative counter), False → Gauge
    points: list[OtlpMetricPoint]


def encode_otlp_metrics(metrics: list[OtlpMetric]) -> bytes:
    """OtlpMetric rows → ExportMetricsServiceRequest bytes
    (opentelemetry.proto.metrics.v1: ResourceMetrics{resource,
    scope_metrics{metrics{name, unit, sum|gauge{data_points}}}})."""
    import struct

    by_service: dict[str, list[OtlpMetric]] = {}
    for m in metrics:
        by_service.setdefault(m.service, []).append(m)
    out = bytearray()
    for service, group in by_service.items():
        sm = bytearray()  # ScopeMetrics
        for m in group:
            mb = bytearray()
            _pb_str(mb, 1, m.name)
            if m.unit:
                _pb_str(mb, 3, m.unit)
            dps = bytearray()
            for p in m.points:
                dp = bytearray()
                for k, v in p.attributes.items():
                    _pb_bytes(dp, 7, _kv_str(k, str(v)))  # NumberDataPoint.attributes
                _pb_fixed64(dp, 3, p.time_ns)  # time_unix_nano
                _put_varint(dp, 4 << 3 | 1)  # as_double fixed64
                dp += struct.pack("<d", p.value)
                _pb_bytes(dps, 1, bytes(dp))
            if m.monotonic:
                _pb_varint(dps, 2, 2)  # AGGREGATION_TEMPORALITY_CUMULATIVE
                _pb_varint(dps, 3, 1)  # is_monotonic
                _pb_bytes(mb, 7, bytes(dps))  # Metric.sum
            else:
                _pb_bytes(mb, 5, bytes(dps))  # Metric.gauge
            _pb_bytes(sm, 2, bytes(mb))  # ScopeMetrics.metrics
        rm = bytearray()
        _pb_bytes(rm, 1, _resource_block(service))
        _pb_bytes(rm, 2, bytes(sm))
        out2 = bytearray()
        _pb_bytes(out2, 1, bytes(rm))
        out += out2
    return bytes(out)


def parse_otlp_metrics(body: bytes) -> list[OtlpMetric]:
    """Inverse subset of encode_otlp_metrics (round-trip pin + any
    future OTLP-metrics intake)."""
    import struct

    out: list[OtlpMetric] = []
    try:
        rms = [bytes(v) for f, v in _iter_fields(body) if f == 1]
    except Exception:
        return out
    for rm in rms:
        service = ""
        sms = []
        try:
            for f2, v2 in _iter_fields(rm):
                if f2 == 1:
                    attrs = [bytes(v3) for f3, v3 in _iter_fields(bytes(v2)) if f3 == 1]
                    service = _attributes(attrs).get("service.name", "")
                elif f2 == 2:
                    sms.append(bytes(v2))
        except Exception:
            continue
        for sm in sms:
            try:
                metric_bufs = [bytes(v) for f, v in _iter_fields(sm) if f == 2]
            except Exception:
                continue
            for mb in metric_bufs:
                name = unit = ""
                monotonic = False
                dp_parent = None
                try:
                    for f3, v3 in _iter_fields(mb):
                        if f3 == 1:
                            name = bytes(v3).decode(errors="replace")
                        elif f3 == 3:
                            unit = bytes(v3).decode(errors="replace")
                        elif f3 == 5:
                            dp_parent = bytes(v3)
                        elif f3 == 7:
                            dp_parent = bytes(v3)
                            monotonic = True
                except Exception:
                    continue
                points = []
                if dp_parent is not None:
                    try:
                        for f4, v4 in _iter_fields(dp_parent):
                            if f4 != 1:
                                continue
                            attrs, t_ns, val = [], 0, 0.0
                            for f5, v5 in _iter_fields(bytes(v4)):
                                if f5 == 7:
                                    attrs.append(bytes(v5))
                                elif f5 == 3:
                                    t_ns = int(v5)
                                elif f5 == 4:
                                    val = struct.unpack(
                                        "<d", int(v5).to_bytes(8, "little")
                                    )[0]
                            points.append(
                                OtlpMetricPoint(_attributes(attrs), t_ns, val)
                            )
                    except Exception:
                        pass
                out.append(OtlpMetric(service, name, unit, monotonic, points))
    return out
