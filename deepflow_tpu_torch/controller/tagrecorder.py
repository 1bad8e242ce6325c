"""tagrecorder — materializes resources into flow_tag dictionaries.

The reference runs ~66 `ch_*.go` updaters that diff MySQL resource
tables into ClickHouse `flow_tag.*_map` dictionaries consumed by the
querier's dictGet translation (controller/tagrecorder/; SURVEY §3.5).
Here one updater serves every kind: on a resource-version change it
rewrites the `<kind>_map` tables in the flow_tag db (id, name + the
attrs the querier surfaces) and invalidates the translator cache.

K8s metadata dictionaries (ch_pod_k8s_label.go / _labels / _annotation
/ _annotations / _env / _envs): pods discovered with labels/annotations
/envs attrs materialize both the singular per-key map (id, key, value —
the `k8s.label.<key>` custom-tag lookup) and the plural one-row-per-pod
map (id, the whole dict JSON-encoded — the `k8s.labels` column seat).

Port copy of deepflow_tpu/controller/tagrecorder.py.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from ..storage.store import ColumnarStore, ColumnSpec, TableSchema
from ..utils.stats import register_countable
from .resources import KINDS, ResourceDB

log = logging.getLogger(__name__)

FLOW_TAG_DB = "flow_tag"

# Compat width of the plural k8s-metadata JSON column. The store column
# is variable-width (object dtype — the ClickHouse String analogue), so
# nothing is ever clipped here; this threshold only feeds the
# `plural_json_truncated` counter, which records how many values WOULD
# be clipped by a fixed-width downstream sink (U1024 exports, the
# pre-r7 store format) so operators can spot them before wiring one up
# (ADVICE.md #1).
PLURAL_JSON_WIDTH = 1024

# pod attr → (singular table stem, plural table stem)
_K8S_META = {
    "labels": ("pod_k8s_label_map", "pod_k8s_labels_map"),
    "annotations": ("pod_k8s_annotation_map", "pod_k8s_annotations_map"),
    "envs": ("pod_k8s_env_map", "pod_k8s_envs_map"),
}


def _map_schema(kind: str) -> TableSchema:
    return TableSchema(
        f"{kind}_map",
        (
            ColumnSpec("time", "u4"),
            ColumnSpec("id", "u4"),
            ColumnSpec("name", "U256"),
        ),
        partition_s=1 << 30,
    )


def _kv_schema(name: str) -> TableSchema:
    return TableSchema(
        name,
        (
            ColumnSpec("time", "u4"),
            ColumnSpec("id", "u4"),
            ColumnSpec("key", "U128"),
            ColumnSpec("value", "U256"),
        ),
        partition_s=1 << 30,
    )


def _plural_schema(name: str) -> TableSchema:
    return TableSchema(
        name,
        (
            ColumnSpec("time", "u4"),
            ColumnSpec("id", "u4"),
            # whole-dict JSON: variable-width (see PLURAL_JSON_WIDTH)
            ColumnSpec("value", "O"),
        ),
        partition_s=1 << 30,
    )


class TagRecorder:
    def __init__(self, db: ResourceDB, store: ColumnarStore, translator=None):
        self.db = db
        self.store = store
        self.translator = translator
        self._synced_version = 0
        self.counters = {"syncs": 0, "rows": 0, "plural_json_truncated": 0}
        register_countable("tagrecorder", self)

    def get_counters(self):
        return dict(self.counters)

    def sync(self) -> bool:
        """Rewrite dictionaries if resources changed; returns whether a
        sync ran. Full rewrite per changed sync — dictionaries are small
        relative to telemetry and the reference's incremental diffing is
        an optimization, not semantics."""
        version = self.db.version
        if version == self._synced_version:
            return False
        for kind, resources in self.db.iter_kinds():
            schema = _map_schema(kind)
            self.store.create_table(FLOW_TAG_DB, schema)
            for pid in self.store.partitions(FLOW_TAG_DB, schema.name):
                self.store.drop_partition(FLOW_TAG_DB, schema.name, pid)
            if resources:
                self.store.insert(
                    FLOW_TAG_DB,
                    schema.name,
                    {
                        "time": np.zeros(len(resources), np.uint32),
                        "id": np.asarray([r.id for r in resources], np.uint32),
                        "name": np.asarray([r.name for r in resources]),
                    },
                )
                self.counters["rows"] += len(resources)
        self._sync_k8s_meta()
        self._synced_version = version
        self.counters["syncs"] += 1
        if self.translator is not None:
            self.translator.invalidate()
        return True

    def _sync_k8s_meta(self) -> None:
        """Materialize pod label/annotation/env dictionaries, singular
        (per key) and plural (whole dict) forms."""
        pods = self.db.list("pod")
        for attr, (singular, plural) in _K8S_META.items():
            ids, keys, values = [], [], []
            p_ids, p_values = [], []
            for r in pods:
                kv = r.attrs.get(attr) or {}
                if not isinstance(kv, dict):
                    continue
                for k, v in sorted(kv.items()):
                    ids.append(r.id)
                    keys.append(str(k))
                    values.append(str(v))
                if kv:
                    p_ids.append(r.id)
                    blob = json.dumps(kv, sort_keys=True)
                    if len(blob) > PLURAL_JSON_WIDTH:
                        # stored intact (variable-width column) — the
                        # counter is a compat metric: a fixed-width
                        # U1024 sink fed from this table WOULD clip
                        # this value to invalid JSON (ADVICE.md #1)
                        self.counters["plural_json_truncated"] += 1
                        log.warning(
                            "%s: pod id=%d %s JSON (%d chars) exceeds the "
                            "U%d fixed-width compat limit; stored intact, "
                            "but fixed-width sinks would truncate it",
                            plural, r.id, attr, len(blob), PLURAL_JSON_WIDTH,
                        )
                    p_values.append(blob)
            for name, schema in ((singular, _kv_schema(singular)),
                                 (plural, _plural_schema(plural))):
                self.store.create_table(FLOW_TAG_DB, schema)
                for pid in self.store.partitions(FLOW_TAG_DB, name):
                    self.store.drop_partition(FLOW_TAG_DB, name, pid)
            if ids:
                self.store.insert(
                    FLOW_TAG_DB, singular,
                    {
                        "time": np.zeros(len(ids), np.uint32),
                        "id": np.asarray(ids, np.uint32),
                        "key": np.asarray(keys),
                        "value": np.asarray(values),
                    },
                )
                self.store.insert(
                    FLOW_TAG_DB, plural,
                    {
                        "time": np.zeros(len(p_ids), np.uint32),
                        "id": np.asarray(p_ids, np.uint32),
                        "value": np.asarray(p_values),
                    },
                )
                self.counters["rows"] += len(ids) + len(p_ids)
