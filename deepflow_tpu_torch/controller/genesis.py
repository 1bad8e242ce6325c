"""Genesis — agent-reported resource discovery.

The reference's genesis plane (server/controller/genesis/: grpc intake
from agents, store with per-vtap lifetimes, updater into the recorder)
covers hosts no cloud adapter knows about: every agent reports its
local interfaces/IPs with each sync, the store keeps them alive on a
lease, and the aggregate becomes one more recorder domain. Same here:
`TrisolarisService` feeds `report()` from the sync payload's
`genesis` key, and `snapshot()` emits the recorder shape with one
`host` resource per agent plus its interfaces as vinterfaces.

Port copy of deepflow_tpu/controller/genesis.py.
"""

from __future__ import annotations

import threading
import time

GENESIS_DOMAIN = "genesis"


class GenesisStore:
    def __init__(self, *, lease_s: float = 130.0, epc_id: int = 0):
        """lease_s: how long a report stays alive without refresh (the
        reference ages vtap data out of the genesis store on the same
        kind of timer); epc_id: EPC assigned to genesis interfaces."""
        self.lease_s = lease_s
        self.epc_id = epc_id
        self._agents: dict[int, dict] = {}
        self._lock = threading.Lock()
        self.counters = {"reports": 0, "expired": 0}

    def report(self, agent_id: int, payload: dict, now: float | None = None) -> None:
        """payload: {"hostname": str, "interfaces": [{"mac": int,
        "ips": [str], "name": str}]} — the agent's local view."""
        now = time.time() if now is None else now
        with self._lock:
            self._agents[agent_id] = {
                "hostname": payload.get("hostname", f"agent-{agent_id}"),
                "interfaces": list(payload.get("interfaces", [])),
                "last_seen": now,
            }
            self.counters["reports"] += 1

    def expire(self, now: float | None = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            dead = [
                aid
                for aid, a in self._agents.items()
                if now - a["last_seen"] > self.lease_s
            ]
            for aid in dead:
                del self._agents[aid]
            self.counters["expired"] += len(dead)
        return len(dead)

    def snapshot(self, now: float | None = None) -> dict:
        """Recorder-shape snapshot of everything still on lease."""
        self.expire(now)
        hosts = []
        vifs = []
        with self._lock:
            for aid, a in sorted(self._agents.items()):
                hosts.append(
                    {
                        "uid": f"genesis/host/{aid}",
                        "name": a["hostname"],
                        "agent_id": aid,
                    }
                )
                for itf in a["interfaces"]:
                    ips = [ip for ip in itf.get("ips", []) if ip]
                    if not ips:
                        continue
                    vifs.append(
                        {
                            "epc_id": self.epc_id,
                            "ips": ips,
                            "mac": int(itf.get("mac", 0)),
                        }
                    )
        return {"resources": {"host": hosts}, "vinterfaces": vifs}

    # mirror the cloud source interface so CloudTask can drive genesis
    domain = GENESIS_DOMAIN
