"""Prometheus label→ID SmartEncoding — the grpc_label_ids.go seat.

The reference's prometheus decoder asks the controller for stable
integer ids for metric names, label names, and label values
(server/ingester/prometheus/decoder/grpc_label_ids.go:1-672), caches
the grants, and writes id-encoded sample rows; the querier re-expands
them through dictionaries. This registry is the allocation authority:
monotonically-assigned ids per namespace, thread-safe, with a versioned
snapshot so the ingester (and a future multi-process sync plane) can
refresh caches the way the reference's gRPC label service does.

Dictionaries persist as storage tables (prometheus.metric_dict /
label_name_dict / label_value_dict) via `flush_dicts` — the query-time
decode reads them like every other flow_tag-style sidecar.

Port copy of deepflow_tpu/controller/prom_labels.py.
"""

from __future__ import annotations

import threading

import numpy as np

from ..storage.store import ColumnSpec, ColumnarStore, TableSchema

METRIC_DICT = TableSchema(
    "metric_dict",
    (ColumnSpec("time", "u4"), ColumnSpec("id", "u4"), ColumnSpec("name", "U128")),
)
LABEL_NAME_DICT = TableSchema(
    "label_name_dict",
    (ColumnSpec("time", "u4"), ColumnSpec("id", "u4"), ColumnSpec("name", "U128")),
)
LABEL_VALUE_DICT = TableSchema(
    "label_value_dict",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("name_id", "u4"),
        ColumnSpec("id", "u4"),
        ColumnSpec("value", "U256"),
    ),
)

SAMPLES_ENC = TableSchema(
    "samples_enc",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("metric_id", "u4"),
        # "name_id:value_id,..." — fixed-width int pairs; the reference
        # stores app-label value ids in per-metric columns, which needs
        # dynamic DDL; the packed pair list is this store's equivalent
        ColumnSpec("label_ids", "U2048"),
        ColumnSpec("value", "f8"),
    ),
)

# encode() truncates at a pair boundary before this so numpy's silent
# string cut can never split a pair (decode also skips malformed pairs)
MAX_PACKED = 2040


class PrometheusLabelRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, int] = {}
        self._label_names: dict[str, int] = {}
        self._label_values: dict[tuple[int, str], int] = {}
        self._next = {"metric": 1, "label_name": 1, "label_value": 1}
        self.version = 0
        # unflushed dictionary rows (id order = allocation order)
        self._dirty: list[tuple[str, tuple]] = []

    def _alloc(self, kind: str) -> int:
        nid = self._next[kind]
        self._next[kind] = nid + 1
        return nid

    # -- allocation (get-or-create, like the reference's grpc grants) ---
    def metric_id(self, name: str) -> int:
        with self._lock:
            mid = self._metrics.get(name)
            if mid is None:
                mid = self._metrics[name] = self._alloc("metric")
                self._dirty.append(("metric", (mid, name)))
                self.version += 1
            return mid

    def label_name_id(self, name: str) -> int:
        with self._lock:
            nid = self._label_names.get(name)
            if nid is None:
                nid = self._label_names[name] = self._alloc("label_name")
                self._dirty.append(("label_name", (nid, name)))
                self.version += 1
            return nid

    def label_value_id(self, name_id: int, value: str) -> int:
        with self._lock:
            key = (name_id, value)
            vid = self._label_values.get(key)
            if vid is None:
                vid = self._label_values[key] = self._alloc("label_value")
                self._dirty.append(("label_value", (name_id, vid, value)))
                self.version += 1
            return vid

    def encode(self, labels: dict[str, str]) -> tuple[int, str]:
        """labels (incl __name__) → (metric_id, packed label-id pairs).

        Packs at most MAX_PACKED chars, truncating at a PAIR boundary
        (trailing labels drop whole — the storage column would otherwise
        cut mid-pair silently)."""
        metric = labels.get("__name__", "")
        mid = self.metric_id(metric)
        pairs = []
        size = 0
        for name in sorted(labels):
            if name == "__name__":
                continue
            nid = self.label_name_id(name)
            vid = self.label_value_id(nid, labels[name])
            pair = f"{nid}:{vid}"
            if size + len(pair) + (1 if pairs else 0) > MAX_PACKED:
                break
            size += len(pair) + (1 if pairs else 0)
            pairs.append(pair)
        return mid, ",".join(pairs)

    # -- decode (query-time dictGet) -------------------------------------
    def decode(self, metric_id: int, packed: str) -> dict[str, str]:
        with self._lock:
            metrics_rev = {v: k for k, v in self._metrics.items()}
            names_rev = {v: k for k, v in self._label_names.items()}
            values_rev = {v: k for k, v in self._label_values.items()}
        labels = {"__name__": metrics_rev.get(metric_id, "")}
        for pair in packed.split(",") if packed else []:
            try:
                nid, vid = (int(x) for x in pair.split(":"))
            except ValueError:
                continue  # damaged/truncated pair: skip, don't crash
            key = values_rev.get(vid)
            if key is not None:
                labels[names_rev.get(nid, str(nid))] = key[1]
        return labels

    # -- restart recovery -------------------------------------------------
    @classmethod
    def load(cls, store: ColumnarStore, db: str = "prometheus") -> "PrometheusLabelRegistry":
        """Rebuild the registry from persisted dictionaries — without
        this, a restart would re-allocate ids from 1 and alias old
        encoded rows onto new names."""
        reg = cls()
        try:
            md = store.scan(db, METRIC_DICT.name)
            for i in range(len(md["id"])):
                reg._metrics[str(md["name"][i])] = int(md["id"][i])
        except KeyError:
            pass
        try:
            ld = store.scan(db, LABEL_NAME_DICT.name)
            for i in range(len(ld["id"])):
                reg._label_names[str(ld["name"][i])] = int(ld["id"][i])
        except KeyError:
            pass
        try:
            lv = store.scan(db, LABEL_VALUE_DICT.name)
            for i in range(len(lv["id"])):
                reg._label_values[(int(lv["name_id"][i]), str(lv["value"][i]))] = int(
                    lv["id"][i]
                )
        except KeyError:
            pass
        reg._next = {
            "metric": max(reg._metrics.values(), default=0) + 1,
            "label_name": max(reg._label_names.values(), default=0) + 1,
            "label_value": max(reg._label_values.values(), default=0) + 1,
        }
        reg.version = len(reg._metrics) + len(reg._label_names) + len(reg._label_values)
        return reg

    # -- persistence ------------------------------------------------------
    def flush_dicts(self, store: ColumnarStore, db: str = "prometheus",
                    now: int = 0) -> int:
        """Write newly-allocated dictionary rows to the sidecar tables."""
        with self._lock:
            dirty, self._dirty = self._dirty, []
        if not dirty:
            return 0
        groups: dict[str, list[tuple]] = {}
        for kind, row in dirty:
            groups.setdefault(kind, []).append(row)
        if "metric" in groups:
            rows = groups["metric"]
            store.create_table(db, METRIC_DICT)
            store.insert(db, METRIC_DICT.name, {
                "time": np.full(len(rows), now, np.uint32),
                "id": np.array([r[0] for r in rows], np.uint32),
                "name": np.array([r[1] for r in rows]),
            })
        if "label_name" in groups:
            rows = groups["label_name"]
            store.create_table(db, LABEL_NAME_DICT)
            store.insert(db, LABEL_NAME_DICT.name, {
                "time": np.full(len(rows), now, np.uint32),
                "id": np.array([r[0] for r in rows], np.uint32),
                "name": np.array([r[1] for r in rows]),
            })
        if "label_value" in groups:
            rows = groups["label_value"]
            store.create_table(db, LABEL_VALUE_DICT)
            store.insert(db, LABEL_VALUE_DICT.name, {
                "time": np.full(len(rows), now, np.uint32),
                "name_id": np.array([r[0] for r in rows], np.uint32),
                "id": np.array([r[1] for r in rows], np.uint32),
                "value": np.array([r[2] for r in rows]),
            })
        return len(dirty)
