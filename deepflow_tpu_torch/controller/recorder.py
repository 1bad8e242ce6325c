"""Recorder — reconcile discovered platform state into ResourceDB.

The reference's recorder (server/controller/recorder/: cache diffing,
db updaters, resource-event publishing) owns the write path into the
resource tables: each cloud/genesis domain periodically produces a
full desired-state snapshot, and the recorder diffs it against what
the DB holds for that domain, issuing creates/updates/deletes and
publishing a resource-change event for each (consumed by the event
ingester → `event` db). Same contract here against the in-process
ResourceDB: snapshots are plain dicts, ownership is tracked per
domain, and IDs are allocated from per-kind pools exactly once per
(domain, uid) so downstream dictionaries stay stable across
re-syncs (recorder/db/idmng.go seat).

Snapshot shape (produced by cloud.py / genesis.py sources):

    {"resources": {kind: [{"uid": str, "name": str, ...attrs}]},
     "vinterfaces": [{"epc_id": int, "ips": [...], "mac": int, ...}]}

Port copy of deepflow_tpu/controller/recorder.py.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from .resources import KINDS, ResourceDB


@dataclasses.dataclass
class ChangeSet:
    created: list = dataclasses.field(default_factory=list)  # (kind, uid)
    updated: list = dataclasses.field(default_factory=list)
    deleted: list = dataclasses.field(default_factory=list)
    vifs_changed: bool = False

    @property
    def total(self) -> int:
        return len(self.created) + len(self.updated) + len(self.deleted)


class Recorder:
    def __init__(self, db: ResourceDB, *, event_sink=None, id_base: int = 1000):
        """event_sink: callable(dict) receiving one resource-event per
        change (the reference pushes these through eventapi to the
        event ingester; server wiring points this at the event plane).
        """
        self.db = db
        self.event_sink = event_sink
        self._lock = threading.Lock()
        # (domain → kind → uid → id); the id is allocated once and
        # survives updates so tag dictionaries stay stable
        self._owned: dict[str, dict[str, dict[str, int]]] = {}
        self._next_id: dict[str, int] = {k: id_base for k in KINDS}
        # per-domain vinterface cache for cheap change detection
        self._vifs: dict[str, list] = {}
        # persistence bookkeeping: save only when the id maps changed
        self.dirty = False
        self.counters = {"reconciles": 0, "creates": 0, "updates": 0, "deletes": 0}

    # -- id pool --------------------------------------------------------
    def _alloc(self, kind: str) -> int:
        nid = self._next_id[kind]
        self._next_id[kind] = nid + 1
        return nid

    def id_of(self, domain: str, kind: str, uid: str) -> int | None:
        with self._lock:
            return self._owned.get(domain, {}).get(kind, {}).get(uid)

    # -- reconcile ------------------------------------------------------
    def reconcile(self, domain: str, snapshot: dict) -> ChangeSet:
        """Diff `snapshot` against this domain's owned resources and
        apply creates/updates/deletes to the DB. Full-state semantics:
        anything owned by the domain and absent from the snapshot is
        deleted (recorder cache diff, recorder/cache/)."""
        cs = ChangeSet()
        desired = snapshot.get("resources", {})
        # validate vinterface rows BEFORE touching anything: a malformed
        # row (misspelled field) must reject the whole snapshot up
        # front, never leave resources applied with the vif table stale
        vifs = [
            self.db._normalize_vif_row(v) for v in snapshot.get("vinterfaces", [])
        ]
        with self._lock:
            owned = self._owned.setdefault(domain, {})
            for kind in KINDS:
                want = {r["uid"]: r for r in desired.get(kind, [])}
                have = owned.setdefault(kind, {})
                for uid, spec in want.items():
                    attrs = {
                        k: v for k, v in spec.items() if k not in ("uid", "name")
                    }
                    attrs["_domain"] = domain
                    attrs["_uid"] = uid
                    rid = have.get(uid)
                    if rid is None:
                        rid = self._alloc(kind)
                        have[uid] = rid
                        self.db.put(kind, rid, spec.get("name", uid), **attrs)
                        cs.created.append((kind, uid))
                    else:
                        cur = self.db.get(kind, rid)
                        if cur is None:
                            # known uid, empty DB: the post-restart
                            # re-materialization (ids loaded, rows not
                            # persisted) — rebuild silently, no event
                            self.db.put(kind, rid, spec.get("name", uid), **attrs)
                        elif (
                            cur.name != spec.get("name", uid)
                            or cur.attrs != attrs
                        ):
                            self.db.put(kind, rid, spec.get("name", uid), **attrs)
                            cs.updated.append((kind, uid))
                for uid in [u for u in have if u not in want]:
                    self.db.delete(kind, have.pop(uid))
                    cs.deleted.append((kind, uid))

            if vifs != self._vifs.get(domain, []):
                self._vifs[domain] = vifs
                self._rebuild_vifs()
                cs.vifs_changed = True

            self.counters["reconciles"] += 1
            self.counters["creates"] += len(cs.created)
            self.counters["updates"] += len(cs.updated)
            self.counters["deletes"] += len(cs.deleted)
            if cs.created or cs.deleted:
                self.dirty = True  # the (uid → id) maps changed

        if self.event_sink is not None:
            now = int(time.time())
            for verb, items in (
                ("create", cs.created),
                ("update", cs.updated),
                ("delete", cs.deleted),
            ):
                for kind, uid in items:
                    self.event_sink(
                        {
                            "time": now,
                            "type": f"{verb}-{kind}",
                            "resource_type": kind,
                            "instance": uid,
                            "domain": domain,
                        }
                    )
        return cs

    # -- persistence ----------------------------------------------------
    # The reference's recorder writes to MySQL, so (domain, uid) → id
    # survives restarts; tag dictionaries persisted by tagrecorder would
    # alias onto re-allocated ids otherwise. Same guarantee here via a
    # JSON snapshot the server saves on tick and loads on boot.
    def save(self, path) -> None:
        import json
        import os

        with self._lock:
            doc = {
                "next_id": dict(self._next_id),
                "owned": {
                    dom: {k: dict(uids) for k, uids in kinds.items()}
                    for dom, kinds in self._owned.items()
                },
            }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        self.dirty = False

    def load(self, path) -> bool:
        import json
        import os

        if not os.path.exists(path):
            return False
        with open(path) as f:
            doc = json.load(f)
        with self._lock:
            # never move an allocator backwards: a load racing local
            # allocations (leader failover) must not re-issue live ids
            for k, v in doc["next_id"].items():
                self._next_id[k] = max(self._next_id.get(k, 0), int(v))
            # merge, don't replace: a locally-allocated (uid → id) that
            # the snapshot predates must keep its id — replacing would
            # re-issue a fresh id for a live uid (the aliasing this
            # whole file exists to prevent). Local wins on conflict,
            # and a loaded id already bound to a DIFFERENT local uid of
            # the same kind is skipped — that uid re-allocates fresh on
            # the next reconcile instead of two uids sharing one id.
            used: dict[str, set] = {}
            for kinds in self._owned.values():
                for kind, uids in kinds.items():
                    used.setdefault(kind, set()).update(uids.values())
            for dom, kinds in doc["owned"].items():
                owned = self._owned.setdefault(dom, {})
                for kind, uids in kinds.items():
                    have = owned.setdefault(kind, {})
                    taken = used.setdefault(kind, set())
                    for uid, rid in uids.items():
                        rid = int(rid)
                        if uid in have or rid in taken:
                            continue
                        have[uid] = rid
                        taken.add(rid)
        return True

    def _rebuild_vifs(self) -> None:
        """Vinterfaces have no per-row identity in ResourceDB, so the
        recorder replaces the whole set (all domains) when any domain's
        set changes — one atomic swap, one version bump (a shrink to
        zero still pushes, and no consumer can observe a half-built
        table)."""
        self.db.replace_vinterfaces(
            [v for dom_vifs in self._vifs.values() for v in dom_vifs]
        )
