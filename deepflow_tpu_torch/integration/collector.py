"""Agent-side integration collector — HTTP intake → wire frames.

The reference agent runs an HTTP server accepting OTLP, Prometheus
remote-write, Telegraf/Influx, and Pyroscope pushes, wraps each body
into a `Sendable` and forwards it to the server unchanged
(agent/src/integration_collector.rs:94-230 — the agent does NOT decode;
decode happens in the server's ingesters). Same here: a threading HTTP
server with one route per source, forwarding raw bodies through the
per-type UniformSenders.

Endpoints (reference paths, integration_collector.rs routes):
  POST /v1/traces                  → OPENTELEMETRY
  POST /api/v1/prom/write          → PROMETHEUS (identity/gzip only —
                                     snappy is unavailable in-image, 415)
  POST /influxdb/api/v2/write      → TELEGRAF
  POST /api/v1/profile             → PROFILE ("svc\\0type\\0ts\\n" + folded)

Port copy of deepflow_tpu/integration/collector.py.
"""

from __future__ import annotations

import gzip
import io
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..ingest.framing import MessageType
from ..ingest.sender import UniformSender
from ..utils.stats import register_countable

_ROUTES = {
    "/v1/traces": MessageType.OPENTELEMETRY,
    "/api/v1/prom/write": MessageType.PROMETHEUS,
    "/influxdb/api/v2/write": MessageType.TELEGRAF,
    "/api/v1/profile": MessageType.PROFILE,
    # SkyWalking SegmentObject pb (agent OAP route) and Datadog JSON
    # traces (integration_collector.rs SkyWalking/Datadog routes)
    "/v3/segment": MessageType.SKYWALKING,
    "/v0.4/traces": MessageType.DATADOG,
}

# request-size guards (the reference bounds bodies via hyper defaults;
# the bind is configurable so a bomb must not exhaust memory)
MAX_BODY_BYTES = 32 << 20
MAX_DECODED_BYTES = 128 << 20


class IntegrationCollector:
    def __init__(
        self,
        servers: list[tuple[str, int]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        agent_id: int = 1,
        organization_id: int = 1,
    ):
        self.senders = {
            mt: UniformSender(
                servers,
                mt,
                agent_id=agent_id,
                organization_id=organization_id,
                prefer_native_queue=False,
            )
            for mt in set(_ROUTES.values())
        }
        self.counters = {"requests": 0, "bad_requests": 0, "bytes_in": 0}
        collector = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                mt = _ROUTES.get(self.path.split("?", 1)[0])
                if mt is None:
                    collector.counters["bad_requests"] += 1
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    collector.counters["bad_requests"] += 1
                    self.send_error(400, "bad Content-Length")
                    return
                if length < 0:
                    collector.counters["bad_requests"] += 1
                    self.send_error(400, "bad Content-Length")
                    return
                if length > MAX_BODY_BYTES:
                    collector.counters["bad_requests"] += 1
                    self.send_error(413, "body too large")
                    return
                body = self.rfile.read(length)
                enc = (self.headers.get("Content-Encoding") or "identity").lower()
                if enc == "gzip":
                    try:
                        # bounded streaming decompress — a gzip bomb must not
                        # expand past MAX_DECODED_BYTES in memory
                        d = gzip.GzipFile(fileobj=io.BytesIO(body))
                        body = d.read(MAX_DECODED_BYTES + 1)
                        if len(body) > MAX_DECODED_BYTES:
                            collector.counters["bad_requests"] += 1
                            self.send_error(413, "decoded body too large")
                            return
                    except (OSError, EOFError, zlib.error):
                        # truncated → EOFError; corrupt deflate → zlib.error
                        collector.counters["bad_requests"] += 1
                        self.send_error(400, "bad gzip body")
                        return
                elif enc == "snappy":
                    collector.counters["bad_requests"] += 1
                    self.send_error(415, "snappy unsupported; use identity or gzip")
                    return
                collector.counters["requests"] += 1
                collector.counters["bytes_in"] += len(body)
                collector.senders[mt].send([bytes(body)])
                self.send_response(204 if mt == MessageType.PROMETHEUS else 200)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        register_countable("integration_collector", self)

    def get_counters(self):
        return dict(self.counters)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        for s in self.senders.values():
            s.close()
