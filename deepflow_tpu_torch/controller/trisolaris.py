"""Agent management & sync — the trisolaris seat.

The reference's trisolaris gRPC service pushes versioned agent configs
and platform-data snapshots; agents poll `Sync` with their current
revisions and receive updates only on change, and keep running on the
last config for `max_escape_duration` when the controller is gone
(agent/src/config/config.rs:2580; controller/trisolaris/). Same
contract here over a line-JSON TCP endpoint (the transport is not the
semantics): `SyncRequest{agent_id, config_rev, platform_version}` →
`SyncResponse` carrying only what changed, plus agent liveness
bookkeeping for the controller's monitor.

Port copy of deepflow_tpu/controller/trisolaris.py.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time

from .resources import ResourceDB


@dataclasses.dataclass
class AgentGroupConfig:
    revision: int = 1
    # the dynamic UserConfig payload (flat dict; agents overlay it on
    # their static YAML)
    config: dict = dataclasses.field(default_factory=dict)
    # agent self-upgrade target for the group (trisolaris upgrade push:
    # the reference serves versioned agent packages; agents reporting a
    # different version get the offer and pull the package)
    upgrade_version: str = ""
    upgrade_package: bytes = b""
    # computed once in set_upgrade — hashing a large package per sync
    # (under the service lock) would serialize every agent
    upgrade_sha256: str = ""
    upgrade_b64: str = ""


class TrisolarisService:
    def __init__(self, db: ResourceDB, *, host: str = "127.0.0.1", port: int = 0,
                 genesis=None, balancer=None):
        self.db = db
        # optional plane hookups: genesis store (agents report local
        # interfaces through sync) and analyzer balancer (sync response
        # carries the agent's assigned ingester)
        self.genesis = genesis
        self.balancer = balancer
        self._groups: dict[str, AgentGroupConfig] = {"default": AgentGroupConfig()}
        # operator-visible trail of what the config migrator renamed on
        # the most recent push (read via the debug server / CLI)
        self.migration_notes: list[str] = []
        self._agent_group: dict[int, str] = {}
        self.agents: dict[int, dict] = {}  # liveness registry
        self._lock = threading.Lock()
        self.counters = {
            "syncs": 0, "config_pushes": 0, "platform_pushes": 0, "upgrade_pulls": 0,
        }

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- config management (REST/agent-group seat) ----------------------
    def set_group_config(self, group: str, config: dict) -> int:
        # normalize any supported config generation on the way in
        # (agent_config migrator seat) so agents always see the flat
        # canonical schema regardless of what the operator wrote
        from ..utils.agent_config import migrate_agent_config

        config, self.migration_notes = migrate_agent_config(config)
        with self._lock:
            g = self._groups.setdefault(group, AgentGroupConfig())
            g.config = dict(config)
            g.revision += 1
            return g.revision

    def assign_agent(self, agent_id: int, group: str) -> None:
        with self._lock:
            self._agent_group[agent_id] = group

    def set_upgrade(self, group: str, version: str, package: bytes) -> None:
        """Stage an agent package for the group (upgrade push seat)."""
        import base64
        import hashlib

        pkg = bytes(package)
        sha = hashlib.sha256(pkg).hexdigest()
        b64 = base64.b64encode(pkg).decode()
        with self._lock:
            g = self._groups.setdefault(group, AgentGroupConfig())
            g.upgrade_version = version
            g.upgrade_package = pkg
            g.upgrade_sha256 = sha
            g.upgrade_b64 = b64

    # -- sync protocol --------------------------------------------------
    def handle_sync(self, req: dict) -> dict:
        if req.get("type") == "upgrade":
            return self._handle_upgrade(req)
        agent_id = int(req.get("agent_id", 0))
        with self._lock:
            group = self._agent_group.get(agent_id, "default")
            g = self._groups.setdefault(group, AgentGroupConfig())
            self.agents[agent_id] = {
                "last_seen": time.time(),
                "group": group,
                "config_rev": req.get("config_rev", 0),
            }
            self.counters["syncs"] += 1
            resp: dict = {
                "config_rev": g.revision,
                "platform_version": self.db.version,
                # NTP seat: agents diff this against their local clock
                # (reference: trident NTP request/response over the same
                # session)
                "server_time_us": int(time.time() * 1_000_000),
            }
            if req.get("config_rev", 0) != g.revision:
                resp["config"] = g.config
                self.counters["config_pushes"] += 1
            if g.upgrade_version and req.get("agent_version", "") != g.upgrade_version:
                resp["upgrade"] = {
                    "version": g.upgrade_version,
                    "size": len(g.upgrade_package),
                    "sha256": g.upgrade_sha256,
                }
        if req.get("platform_version", 0) != self.db.version:
            resp["platform"] = self._platform_snapshot()
            self.counters["platform_pushes"] += 1
        if self.genesis is not None and "genesis" in req:
            self.genesis.report(agent_id, req["genesis"])
        if self.balancer is not None:
            ip = self.balancer.assign(agent_id)
            if ip is not None:
                resp["analyzer_ip"] = ip
        return resp

    def _handle_upgrade(self, req: dict) -> dict:
        """Package pull: {type: 'upgrade', agent_id, version} →
        {version, sha256, package_b64}."""
        agent_id = int(req.get("agent_id", 0))
        with self._lock:
            group = self._agent_group.get(agent_id, "default")
            g = self._groups.setdefault(group, AgentGroupConfig())
            if not g.upgrade_version:
                return {"error": "no upgrade staged"}
            self.counters["upgrade_pulls"] += 1
            return {
                "version": g.upgrade_version,
                "sha256": g.upgrade_sha256,
                "package_b64": g.upgrade_b64,
            }

    def _platform_snapshot(self) -> dict:
        """Compact platform payload: what agents need for local tagging
        (interfaces + EPCs), not the full info matrix."""
        vifs = []
        with self.db._lock:
            for v in self.db._vifs:
                vifs.append(
                    {"epc_id": v["epc_id"], "ips": v["ips"], "mac": v["mac"], "pod_id": v["pod_id"]}
                )
        return {"interfaces": vifs}

    # -- TCP line-JSON server -------------------------------------------
    def _serve(self):
        while self._running:
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except (TimeoutError, OSError):
                continue
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    def _client(self, conn: socket.socket):
        with conn:
            f = conn.makefile("rwb")
            for line in f:
                try:
                    req = json.loads(line)
                    resp = self.handle_sync(req)
                except Exception:
                    resp = {"error": "bad request"}
                f.write(json.dumps(resp).encode() + b"\n")
                f.flush()

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)
        self._srv.close()


class AgentSyncClient:
    """Agent-side sync loop state with max_escape semantics: the last
    good config stays active while the controller is unreachable, up to
    `max_escape_s`, after which the agent reverts to defaults and marks
    itself disconnected (config.rs:2580 behavior)."""

    def __init__(
        self,
        servers: list[tuple[str, int]],
        agent_id: int,
        *,
        max_escape_s: float = 3600.0,
        defaults: dict | None = None,
    ):
        self.servers = servers
        self.agent_id = agent_id
        self.max_escape_s = max_escape_s
        self.defaults = dict(defaults or {})
        self.config = dict(self.defaults)
        self.config_rev = 0
        self.platform_version = 0
        self.platform: dict = {}
        self.last_success: float | None = None
        self.escaped = False
        self.agent_version = ""
        # ingester this agent ships to (balancer assignment in the sync
        # response; sticky server-side, kept across escapes here)
        self.analyzer_ip: str | None = None
        # NTP diff vs controller clock (µs; trident's NTP-over-session)
        self.ntp_offset_us = 0
        self.pending_upgrade: dict | None = None
        self.counters = {"syncs_ok": 0, "syncs_failed": 0, "escapes": 0,
                         "upgrades": 0}

    def _rpc(self, req: dict) -> tuple[dict, float, float] | None:
        """Returns (resp, t_send, t_recv) bracketing only the SUCCESSFUL
        attempt — failover time on dead servers must not leak into the
        NTP midpoint."""
        for host, port in self.servers:
            try:
                with socket.create_connection((host, port), timeout=2.0) as s:
                    f = s.makefile("rwb")
                    t_send = time.time()
                    f.write(json.dumps(req).encode() + b"\n")
                    f.flush()
                    resp = json.loads(f.readline())
                    t_recv = time.time()
            except (OSError, ValueError):
                continue
            if "error" not in resp:
                return resp, t_send, t_recv
        return None

    def sync_once(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        req = {
            "agent_id": self.agent_id,
            "config_rev": self.config_rev,
            "platform_version": self.platform_version,
            "agent_version": self.agent_version,
        }
        got = self._rpc(req)
        if got is None:
            self.counters["syncs_failed"] += 1
            self._check_escape(now)
            return False
        resp, t_send, t_recv = got
        if "config" in resp:
            self.config = {**self.defaults, **resp["config"]}
        if "platform" in resp:
            self.platform = resp["platform"]
        if "server_time_us" in resp:
            # midpoint correction: offset = server - (send+recv)/2
            mid_us = (t_send + t_recv) / 2 * 1_000_000
            self.ntp_offset_us = int(resp["server_time_us"] - mid_us)
        self.pending_upgrade = resp.get("upgrade")
        if resp.get("analyzer_ip"):
            self.analyzer_ip = resp["analyzer_ip"]
        self.config_rev = resp["config_rev"]
        self.platform_version = resp["platform_version"]
        self.last_success = now
        self.escaped = False
        self.counters["syncs_ok"] += 1
        return True

    def corrected_time_us(self, now: float | None = None) -> int:
        """Local clock adjusted onto the controller's (NTP seat)."""
        now = time.time() if now is None else now
        return int(now * 1_000_000) + self.ntp_offset_us

    def pull_upgrade(self) -> tuple[str, bytes] | None:
        """Fetch + verify the staged package; returns (version, bytes)
        for the caller to install, or None. The caller MUST call
        confirm_upgrade(version) only after a successful install — a
        failed install must keep the offer pending so it retries."""
        import base64
        import hashlib

        if not self.pending_upgrade:
            return None
        got = self._rpc({"type": "upgrade", "agent_id": self.agent_id})
        if got is None:
            return None
        resp, _t0, _t1 = got
        pkg = base64.b64decode(resp.get("package_b64", ""))
        if hashlib.sha256(pkg).hexdigest() != resp.get("sha256"):
            return None  # corrupt transfer: keep the offer pending
        return resp["version"], pkg

    def confirm_upgrade(self, version: str) -> None:
        """Install succeeded: report the new version so the controller
        stops offering, and count it."""
        self.agent_version = version
        self.pending_upgrade = None
        self.counters["upgrades"] += 1

    def _check_escape(self, now: float) -> None:
        if self.last_success is None:
            return
        if not self.escaped and now - self.last_success > self.max_escape_s:
            # escape: revert to static defaults (config.rs:2580). The
            # revision resets too — a returning controller with an
            # unchanged revision must still re-push the real config
            self.config = dict(self.defaults)
            self.config_rev = 0
            self.escaped = True
            self.counters["escapes"] += 1
