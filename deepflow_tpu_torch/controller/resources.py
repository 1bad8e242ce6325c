"""Resource registry — the controller's source of truth.

The reference reconciles cloud/K8s discovery into MySQL tables
(controller/recorder/) that every downstream consumer reads: tagrecorder
materializes them into CK dictionaries, trisolaris pushes them to agents
as platform data, and the ingester's PlatformInfoTable refreshes from
them (SURVEY §3.5). This module is that source of truth without MySQL:
typed in-process tables with a global version bumped on every mutation,
so consumers sync by version the way trisolaris does.

Port copy of deepflow_tpu/controller/resources.py.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

from ..enrich.platform import PlatformInfoTable


@dataclasses.dataclass
class Resource:
    id: int
    name: str
    # kind-specific fields ride in `attrs` (epc_id, ips, region_id…)
    attrs: dict = dataclasses.field(default_factory=dict)


# resource kinds — each becomes a tagrecorder dictionary `<kind>_map`
# (the ch_* updater set, controller/tagrecorder/ch_pod.go etc.)
KINDS = (
    "region",
    "az",
    "subnet",
    "host",
    "l3_epc",
    "pod_cluster",
    "pod_ns",
    "pod_node",
    "pod_group",
    "pod",
    "pod_service",
    "gprocess",
    "custom_service",
    "device",
    "auto_service",
    "auto_instance",
)


class ResourceDB:
    def __init__(self):
        self._tables: dict[str, dict[int, Resource]] = {k: {} for k in KINDS}
        self._vifs: list[dict] = []  # vinterfaces: mac/ips → device binding
        self._lock = threading.Lock()
        self.version = 1

    # -- mutation (recorder writes) -------------------------------------
    def put(self, kind: str, id: int, name: str, **attrs) -> Resource:
        if kind not in self._tables:
            raise KeyError(f"unknown resource kind {kind}")
        r = Resource(id, name, attrs)
        with self._lock:
            self._tables[kind][id] = r
            self.version += 1
        return r

    def delete(self, kind: str, id: int) -> bool:
        with self._lock:
            existed = self._tables[kind].pop(id, None) is not None
            if existed:
                self.version += 1
        return existed

    # one row-normalization shared by both vif write paths, so the
    # incremental and full-state writers cannot drift apart
    _VIF_DEFAULTS = dict(
        epc_id=0, ips=(), mac=0, pod_id=0, region_id=0, az_id=0,
        subnet_id=0, host_id=0, pod_node_id=0, pod_ns_id=0,
        pod_group_id=0, pod_cluster_id=0, l3_device_id=0,
        l3_device_type=0,
    )
    _VIF_ALIASES = {"device_id": "l3_device_id", "device_type": "l3_device_type"}

    @classmethod
    def _normalize_vif_row(cls, v: dict) -> dict:
        row = dict(cls._VIF_DEFAULTS)
        for k, val in v.items():
            k = cls._VIF_ALIASES.get(k, k)
            if k.startswith("_"):
                continue  # source-internal markers (e.g. _pod_uid)
            if k not in cls._VIF_DEFAULTS:
                # misspelled operator fields must surface, not silently
                # default; rows are all normalized BEFORE any mutation
                # (replace_vinterfaces), so raising stays atomic
                raise KeyError(f"unknown vinterface field {k!r}")
            row[k] = val
        row["ips"] = list(row["ips"])
        return row

    def add_vinterface(self, *, epc_id: int, ips: list, **fields) -> None:
        """One interface (the vinterface/IP rows joined): what agents and
        the ingester resolve MAC/EPC+IP against."""
        row = self._normalize_vif_row(dict(epc_id=epc_id, ips=ips, **fields))
        with self._lock:
            self._vifs.append(row)
            self.version += 1

    def replace_vinterfaces(self, vifs: list[dict]) -> None:
        """Atomically swap the whole vinterface set (recorder full-state
        writes): one version bump, no window where consumers can observe
        a cleared-but-not-yet-refilled table."""
        rows = [self._normalize_vif_row(v) for v in vifs]
        with self._lock:
            self._vifs[:] = rows
            self.version += 1

    # -- reads ----------------------------------------------------------
    def get(self, kind: str, id: int) -> Resource | None:
        with self._lock:
            return self._tables[kind].get(id)

    def list(self, kind: str) -> list[Resource]:
        with self._lock:
            return list(self._tables[kind].values())

    def iter_kinds(self) -> Iterator[tuple[str, list[Resource]]]:
        with self._lock:
            snapshot = {k: list(t.values()) for k, t in self._tables.items()}
        yield from snapshot.items()

    # -- consumers ------------------------------------------------------
    def vinterfaces(self) -> list[dict]:
        """Normalized vinterface rows (copies)."""
        with self._lock:
            return [dict(v) for v in self._vifs]

    def build_platform_table(self, my_region_id: int = 0) -> PlatformInfoTable:
        """The grpc_platformdata refresh path: resources → the enrichment
        kernel's host-side builder."""
        pt = PlatformInfoTable(my_region_id=my_region_id)
        with self._lock:
            vifs = [dict(v) for v in self._vifs]
            gprocs = list(self._tables["gprocess"].values())
            podsvcs = list(self._tables["pod_service"].values())
            customs = list(self._tables["custom_service"].values())
        for v in vifs:
            ips = v.pop("ips")
            epc = v.pop("epc_id")
            mac = v.pop("mac")
            pod = v.pop("pod_id")
            pt.add_info(epc_id=epc, ips=ips, mac=mac, pod_id=pod, **v)
        for g in gprocs:
            pt.add_gprocess(g.id, g.attrs.get("agent_id", 0), g.attrs.get("pod_id", 0))
        for s in podsvcs:
            pt.add_pod_service(
                s.id,
                pod_group_id=s.attrs.get("pod_group_id", 0),
                pod_node_id=s.attrs.get("pod_node_id", 0),
                protocol=s.attrs.get("protocol", 0),
                server_port=s.attrs.get("server_port", 0),
            )
        for c in customs:
            pt.add_custom_service(
                c.id,
                epc_id=c.attrs.get("epc_id", 0),
                ip=c.attrs.get("ip", 0),
                server_port=c.attrs.get("server_port", 0),
            )
        return pt
