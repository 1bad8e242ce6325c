"""UDP debug endpoint — the ingesterctl / libs/debug seat.

The reference exposes a UDP RPC on every server for `deepflow-ctl
ingester`/`agent` debug commands: queue taps, counter dumps, platform
dumps, loglevel (server/libs/debug/simple_debug.go;
ingesterctl/const.go:27-61). Here: one JSON-datagram endpoint serving
the counter registry, table/row inventories, agent liveness, and
datasource listings. Request {"cmd": ..., **args} → JSON reply
(truncated to fit one datagram; big answers page with "offset").

Port copy of deepflow_tpu/server/debug.py.
"""

from __future__ import annotations

import json
import socket
import threading

from ..utils.stats import default_collector

MAX_DGRAM = 60000


class DebugServer:
    def __init__(self, *, host: str = "127.0.0.1", port: int = 0, context: dict | None = None):
        """context: named objects commands can inspect — "store",
        "trisolaris", "downsampler", "ingesters"… all optional."""
        self.context = context or {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._sock.settimeout(0.2)
        while self._running:
            try:
                data, addr = self._sock.recvfrom(65535)
            except (TimeoutError, OSError):
                continue
            try:
                req = json.loads(data)
                resp = self._handle(req)
            except Exception as e:
                resp = {"error": str(e)}
            payload = json.dumps(resp).encode()
            if len(payload) > MAX_DGRAM:
                payload = json.dumps({"error": "reply too large; page with offset/limit"}).encode()
            try:
                self._sock.sendto(payload, addr)
            except OSError:
                pass

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "counters":
            # read the ring, never tick(): a read-only RPC must not push
            # snapshots into sinks (the dfstats pipeline) as a side effect
            pts = default_collector.recent() or default_collector.tick()
            module = req.get("module")
            out = [
                {"module": p.module, "tags": dict(p.tags), "fields": p.fields}
                for p in pts
                if module is None or p.module == module
            ]
            off = int(req.get("offset", 0))
            return {"counters": out[off : off + int(req.get("limit", 200))]}
        if cmd == "tables":
            store = self.context.get("store")
            if store is None:
                return {"error": "no store attached"}
            out = {}
            for db in store.databases():
                out[db] = {t: store.row_count(db, t) for t in store.tables(db)}
            return {"tables": out}
        if cmd == "agents":
            tri = self.context.get("trisolaris")
            if tri is None:
                return {"error": "no controller attached"}
            return {"agents": {str(k): v for k, v in tri.agents.items()}}
        if cmd == "datasources":
            dsm = self.context.get("downsampler")
            if dsm is None:
                return {"error": "no downsampler attached"}
            from .datasource import list_cascade_tiers

            return {
                "datasources": [
                    {
                        "name": d.name,
                        "base": d.base_table,
                        "interval": d.interval,
                        "watermark": d.watermark,
                        "served_by": "downsampler",
                    }
                    for d in dsm.list()
                ]
                # tiers the rollup cascade serves on device:
                # no watermark — the tier closes with its last child
                # window, there is no store-side scan to track
                + [
                    {"name": r["name"], "base": r["base_table"],
                     "interval": r["interval"], "served_by": "cascade"}
                    for r in list_cascade_tiers()
                ]
            }
        if cmd == "subscriptions":
            # push query plane: active standing queries with
            # watcher counts and eval latency — the dfctl listing
            subs = self.context.get("subscriptions")
            if subs is None:
                return {"error": "no subscription manager attached"}
            return {
                "subscriptions": subs.list_subscriptions(),
                "counters": subs.get_counters(),
            }
        if cmd == "alerts":
            alerts = self.context.get("alerts")
            if alerts is None:
                return {"error": "no alert engine attached"}
            return {
                "alerts": alerts.list_rules(),
                "counters": alerts.get_counters(),
            }
        if cmd == "ping":
            return {"pong": True}
        return {"error": f"unknown cmd {cmd!r}"}

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)
        self._sock.close()


def debug_request(host: str, port: int, req: dict, timeout: float = 3.0) -> dict:
    """Client side (the deepflow-ctl UDP call)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(json.dumps(req).encode(), (host, port))
        data, _ = s.recvfrom(65535)
        return json.loads(data)
    finally:
        s.close()
