"""trident.proto gRPC facade — stock-agent registration compatibility.

Port copy of deepflow_tpu/controller/trident_grpc.py.

The control plane here speaks JSON-lines (a documented deviation); this
facade puts a real gRPC `trident.Synchronizer` endpoint in front of
TrisolarisService so a stock deepflow-agent can register and receive
config pushes: Sync + AnalyzerSync (unary) and Push (server-streaming)
over the byte-exact wire subset of message/trident.proto:

  SyncRequest:  boot_time(1), config_accepted(2), revision(5),
                process_name(7), version_platform_data(9),
                ctrl_ip(21), host(22), ctrl_mac(25),
                vtap_group_id_request(26), cpu_num(32)
  SyncResponse: status(1)=SUCCESS, config(2){enabled(1), sync_interval
                (4), vtap_id(40)}, revision(4),
                version_platform_data(6)

Messages are built/parsed with the same hand-rolled varint codec as the
rest of the framework (no generated stubs — grpcio's generic handlers
carry raw bytes). Agent identity follows the reference's IP_AND_MAC
default (AgentIdentifier, trident.proto:91): (ctrl_ip, ctrl_mac) maps
to a stable allocated vtap_id.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures

from ..ingest.codec import (
    _iter_fields,
    pb_bytes as _pb_sub,
    pb_str as _pb_str,
    pb_varint as _pb_varint,
)

STATUS_SUCCESS = 0
STATUS_HEARTBEAT = 2


def parse_sync_request(body: bytes) -> dict:
    req: dict = {}
    names = {1: "boot_time", 5: "revision", 7: "process_name",
             9: "version_platform_data", 21: "ctrl_ip", 22: "host",
             25: "ctrl_mac", 26: "vtap_group_id_request", 32: "cpu_num"}
    try:
        for f, v in _iter_fields(body):
            name = names.get(f)
            if name is None:
                continue
            if isinstance(v, (bytes, bytearray)):
                req[name] = bytes(v).decode(errors="replace")
            else:
                req[name] = int(v)
    except ValueError:
        pass  # truncated/garbled frame → whatever parsed so far
    return req


def build_sync_response(*, vtap_id: int, sync_interval: int,
                        platform_version: int, revision: str = "",
                        config_push: bool = True,
                        status: int = STATUS_SUCCESS) -> bytes:
    out = bytearray()
    _pb_varint(out, 1, status)
    if config_push:
        cfg = bytearray()
        _pb_varint(cfg, 1, 1)  # enabled
        _pb_varint(cfg, 4, sync_interval)
        _pb_varint(cfg, 40, vtap_id)
        _pb_sub(out, 2, bytes(cfg))
    if revision:
        _pb_str(out, 4, revision)
    _pb_varint(out, 6, platform_version)
    return bytes(out)


def parse_sync_response(body: bytes) -> dict:
    """Client-side decode of the subset (tests + SDK); total on
    garbage input like every untrusted-edge decoder here."""
    resp: dict = {}
    try:
        _parse_sync_response_into(resp, body)
    except ValueError:
        pass
    return resp


def _parse_sync_response_into(resp: dict, body: bytes) -> None:
    for f, v in _iter_fields(body):
        if f == 1:
            resp["status"] = int(v)
        elif f == 2 and isinstance(v, (bytes, bytearray)):
            cfg = {}
            for f2, v2 in _iter_fields(bytes(v)):
                if f2 == 1:
                    cfg["enabled"] = bool(v2)
                elif f2 == 4:
                    cfg["sync_interval"] = int(v2)
                elif f2 == 40:
                    cfg["vtap_id"] = int(v2)
            resp["config"] = cfg
        elif f == 4 and isinstance(v, (bytes, bytearray)):
            resp["revision"] = bytes(v).decode(errors="replace")
        elif f == 6:
            resp["version_platform_data"] = int(v)


class TridentGrpcFacade:
    """gRPC front for TrisolarisService (Sync + config push subset)."""

    def __init__(self, trisolaris, *, host: str = "127.0.0.1", port: int = 0,
                 sync_interval: int = 60, push_poll_s: float = 0.2,
                 push_heartbeat_s: float = 10.0, max_workers: int = 32):
        import grpc

        self._tri = trisolaris
        self.sync_interval = sync_interval
        self.push_poll_s = push_poll_s
        self.push_heartbeat_s = push_heartbeat_s
        # each long-lived Push stream PINS one executor thread for the
        # client's lifetime (the generator sleep-polls), so the pool
        # bounds the concurrent stock-agent count — size it accordingly
        self._lock = threading.Lock()
        self._ids: dict[tuple[str, str], int] = {}
        self._next_id = 1  # vtap ids are dense and ≤ 64000 (trident.proto:57)
        self.counters = {"syncs": 0, "registers": 0, "pushes": 0}

        handlers = {
            "Sync": grpc.unary_unary_rpc_method_handler(self._sync),
            "AnalyzerSync": grpc.unary_unary_rpc_method_handler(self._sync),
            "Push": grpc.unary_stream_rpc_method_handler(self._push),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("trident.Synchronizer", handlers),)
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    # -- identity --------------------------------------------------------
    def _vtap_id(self, req: dict) -> int:
        key = (req.get("ctrl_ip", ""), req.get("ctrl_mac", ""))
        with self._lock:
            vid = self._ids.get(key)
            if vid is None:
                vid = self._next_id
                self._next_id += 1
                self._ids[key] = vid
                self.counters["registers"] += 1
            return vid

    # -- rpc bodies ------------------------------------------------------
    def _sync_response(self, body: bytes) -> bytes:
        req = parse_sync_request(bytes(body))
        vid = self._vtap_id(req)
        group = req.get("vtap_group_id_request") or "default"
        self._tri.assign_agent(vid, group)
        resp = self._tri.handle_sync({
            "agent_id": vid,
            "agent_version": req.get("revision", ""),
            "platform_version": req.get("version_platform_data", 0),
            # a stock agent has no JSON config revision; 0 forces the
            # first push, after which version_platform_data gates
            "config_rev": -1,
        })
        self.counters["syncs"] += 1
        return build_sync_response(
            vtap_id=vid,
            sync_interval=self.sync_interval,
            platform_version=int(resp.get("platform_version", 0)),
            revision=str(resp.get("upgrade", {}).get("version", "")),
        )

    def _sync(self, body, context):
        return self._sync_response(body)

    def _push(self, body, context):
        """Server-streaming config push: one immediate response, then
        one per platform/config revision change, plus periodic
        heartbeats (the reference controller pushes on an interval too;
        a steady message flow also keeps gRPC's blocking-iterator
        stream adapter from parking a response in an unflushed
        buffer)."""
        yield self._sync_response(body)
        last = self._tri.db.version
        last_beat = time.time()
        while context.is_active():
            time.sleep(self.push_poll_s)
            cur = self._tri.db.version
            beat = time.time() - last_beat >= self.push_heartbeat_s
            if cur != last or beat:
                if cur != last:
                    self.counters["pushes"] += 1
                last = cur
                last_beat = time.time()
                yield self._sync_response(body)

    def stop(self) -> None:
        self._server.stop(grace=0.5)
