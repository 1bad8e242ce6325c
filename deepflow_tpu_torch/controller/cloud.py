"""Cloud discovery — platform sources that produce recorder snapshots.

The reference's cloud plane (server/controller/cloud/: one adapter per
provider plus filereader and kubernetes_gather) normalizes provider
APIs into a common resource model the recorder consumes. Two sources
cover the same seats here:

  * `FileReaderPlatform` — declarative resource documents (the
    reference's cloud/filereader: YAML in, resources out), used for
    static/test topologies.
  * `KubernetesGather` — transforms a K8s object snapshot (nodes,
    namespaces, pods, services — the shapes `kubectl get -o json`
    emits) into pod_cluster/pod_node/pod_ns/pod_group/pod/pod_service
    resources and pod vinterfaces, following
    cloud/kubernetes_gather's mapping. There is no apiserver in this
    environment, so the gather consumes a parsed object dict; the
    watch loop is the caller's concern (CloudTask).

Both emit the recorder snapshot shape (see recorder.py docstring).

Port copy of deepflow_tpu/controller/cloud.py.
"""

from __future__ import annotations

import threading
import time

from .recorder import Recorder


class FileReaderPlatform:
    """Static resource document → snapshot (cloud/filereader seat)."""

    def __init__(self, doc: dict, *, domain: str = "file"):
        self.domain = domain
        self._doc = doc

    @classmethod
    def from_yaml(cls, path: str, *, domain: str = "file"):
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f), domain=domain)

    def update(self, doc: dict) -> None:
        self._doc = doc

    def snapshot(self) -> dict:
        return {
            "resources": dict(self._doc.get("resources", {})),
            "vinterfaces": list(self._doc.get("vinterfaces", [])),
        }


class KubernetesGather:
    """K8s object lists → resource snapshot (cloud/kubernetes_gather).

    Expects `objects` = {"nodes": [...], "namespaces": [...],
    "pods": [...], "services": [...]} where each item is the usual
    metadata/spec/status shape. The epc for the whole cluster comes
    from `epc_id` (the reference allocates a VPC per cluster domain).
    """

    def __init__(self, objects: dict, *, domain: str = "k8s",
                 cluster_name: str = "cluster", epc_id: int = 1,
                 region_uid: str = "default-region", az_uid: str = "default-az"):
        self.domain = domain
        self.cluster_name = cluster_name
        self.epc_id = epc_id
        self.region_uid = region_uid
        self.az_uid = az_uid
        self._objects = objects

    def update(self, objects: dict) -> None:
        self._objects = objects

    def snapshot(self) -> dict:
        o = self._objects
        cluster_uid = f"{self.domain}/{self.cluster_name}"
        res: dict[str, list] = {
            "region": [{"uid": self.region_uid, "name": self.region_uid}],
            "az": [{"uid": self.az_uid, "name": self.az_uid,
                    "region": self.region_uid}],
            "l3_epc": [{"uid": f"{cluster_uid}/epc", "name": self.cluster_name,
                        "epc_id": self.epc_id}],
            "pod_cluster": [{"uid": cluster_uid, "name": self.cluster_name}],
            "pod_node": [],
            "pod_ns": [],
            "pod_group": [],
            "pod": [],
            "pod_service": [],
        }
        vifs: list = []

        for node in o.get("nodes", []):
            name = node["metadata"]["name"]
            ip = ""
            for a in node.get("status", {}).get("addresses", []):
                if a.get("type") == "InternalIP":
                    ip = a.get("address", "")
            res["pod_node"].append(
                {"uid": f"{cluster_uid}/node/{name}", "name": name,
                 "cluster": cluster_uid, "ip": ip}
            )

        for ns in o.get("namespaces", []):
            name = ns["metadata"]["name"]
            res["pod_ns"].append(
                {"uid": f"{cluster_uid}/ns/{name}", "name": name,
                 "cluster": cluster_uid}
            )

        # pod groups come from ownerReferences; Deployment-managed pods
        # reference the ReplicaSet (name = "<deployment>-<template-hash>"),
        # so trim the hash to keep group identity stable across rollouts
        # (kubernetes_gather's RS→Deployment resolution)
        groups: dict[str, dict] = {}
        for pod in o.get("pods", []):
            md = pod["metadata"]
            ns = md.get("namespace", "default")
            owner = ""
            for ref in md.get("ownerReferences", []):
                owner = ref.get("name", "")
                if ref.get("kind") == "ReplicaSet" and "-" in owner:
                    stem, _, tail = owner.rpartition("-")
                    # pod-template hashes use k8s' SafeEncodeString
                    # alphabet (no vowels, no 0/1/3) — checking it keeps
                    # bare ReplicaSets like "redis-master" distinct
                    if 5 <= len(tail) <= 10 and all(
                        ch in "bcdfghjklmnpqrstvwxz2456789" for ch in tail
                    ):
                        owner = stem
            if owner:
                guid = f"{cluster_uid}/group/{ns}/{owner}"
                groups.setdefault(
                    guid,
                    {"uid": guid, "name": owner, "ns": ns, "cluster": cluster_uid},
                )
            pod_uid = f"{cluster_uid}/pod/{ns}/{md['name']}"
            pod_ip = pod.get("status", {}).get("podIP", "")
            # container env vars (first container wins per key) — feeds
            # the ch_pod_k8s_env* dictionary seat
            envs: dict[str, str] = {}
            for c in pod.get("spec", {}).get("containers", []):
                for ev in c.get("env", []) or []:
                    if "name" in ev and "value" in ev:
                        envs.setdefault(ev["name"], str(ev["value"]))
            res["pod"].append(
                {
                    "uid": pod_uid,
                    "name": md["name"],
                    "ns": ns,
                    "node": pod.get("spec", {}).get("nodeName", ""),
                    "group": owner,
                    "ip": pod_ip,
                    "labels": dict(md.get("labels", {})),
                    "annotations": dict(md.get("annotations", {})),
                    "envs": envs,
                }
            )
            if pod_ip:
                vifs.append(
                    {"epc_id": self.epc_id, "ips": [pod_ip], "pod_id": 0,
                     "_pod_uid": pod_uid}
                )
        res["pod_group"] = list(groups.values())

        for svc in o.get("services", []):
            md = svc["metadata"]
            ns = md.get("namespace", "default")
            res["pod_service"].append(
                {
                    "uid": f"{cluster_uid}/svc/{ns}/{md['name']}",
                    "name": md["name"],
                    "ns": ns,
                    "cluster_ip": svc.get("spec", {}).get("clusterIP", ""),
                }
            )
        return {"resources": res, "vinterfaces": vifs}


class CloudTask:
    """Periodic source→recorder pump (cloud/cloud.go task loop). The
    pod vinterfaces carry a `_pod_uid` marker that is resolved to the
    recorder-allocated pod id just before reconcile, so enrichment
    lookups land on stable ids."""

    def __init__(self, source, recorder: Recorder, *, interval_s: float = 30.0):
        self.source = source
        self.recorder = recorder
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_change = None
        self.last_error: Exception | None = None
        self.counters = {"polls": 0, "errors": 0}

    def safe_poll(self):
        """poll() with the loop's error stance: failures are recorded
        (last_error, errors counter) and invalidate last_change so a
        stale ChangeSet never counts as fresh discovery activity."""
        try:
            return self.poll()
        except Exception as e:
            self.last_error = e
            self.last_change = None
            self.counters["errors"] += 1
            return None

    def poll(self):
        snap = self.source.snapshot()
        domain = self.source.domain
        # second pass: resolve uid markers → recorder ids (ids exist
        # after the first reconcile; fresh resources resolve on the next
        # poll, which reconcile's vif change-detection triggers).
        # `_pod_uid: uid` is the K8s shorthand; `_refs: [(field, kind,
        # uid), ...]` is the general form cloud adapters emit. Rebuild
        # rows instead of popping in place: snapshot() may alias the
        # source's own documents (e.g. FileReaderPlatform's dicts).
        vifs = snap.get("vinterfaces")
        if vifs:
            resolved = []
            for v in vifs:
                uid = v.get("_pod_uid")
                refs = list(v.get("_refs") or ())
                if uid is not None:
                    refs.append(("pod_id", "pod", uid))
                if refs:
                    v = {k: x for k, x in v.items() if k not in ("_pod_uid", "_refs")}
                    for field, kind, ruid in refs:
                        v[field] = self.recorder.id_of(domain, kind, ruid) or 0
                resolved.append(v)
            snap = dict(snap, vinterfaces=resolved)
        self.last_change = self.recorder.reconcile(domain, snap)
        self.counters["polls"] += 1
        return self.last_change

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.safe_poll()
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
