"""Query-time tag translation — the dictGet seat.
Port copy of deepflow_tpu/querier/translation.py.

The reference decodes SmartEncoding integer tags back to names at query
time via ClickHouse dictionaries materialized by tagrecorder
(`dictGet('flow_tag.pod_map', ...)`, tag/translation.go:95-150). Here
the same dictionaries live as `flow_tag.<kind>_map` tables in the store
(written by the controller's tagrecorder); `Translator.translate` loads
a map lazily, caches it, and gathers names for an id column. Enum-coded
columns (tap_side, protocol…) translate from static tables.
"""

from __future__ import annotations

import numpy as np

# tag column (or its _0/_1 sided variants) → dictionary table kind
_COLUMN_DICT = {
    "pod_id": "pod",
    "pod_node_id": "pod_node",
    "pod_ns_id": "pod_ns",
    "pod_group_id": "pod_group",
    "pod_cluster_id": "pod_cluster",
    "region_id": "region",
    "az_id": "az",
    "subnet_id": "subnet",
    "host_id": "host",
    "l3_device_id": "device",
    "l3_epc_id": "l3_epc",
    "gprocess_id": "gprocess",
    "auto_service_id": "auto_service",
    "auto_instance_id": "auto_instance",
}

_ENUMS = {
    "tap_side": {0: "rest", 1: "c", 2: "s", 9: "c-nd", 10: "s-nd", 17: "c-hv", 18: "s-hv",
                 33: "c-gw", 34: "s-gw", 41: "c-p", 42: "s-p", 49: "c-app", 50: "s-app", 48: "app"},
    "protocol": {0: "unknown", 1: "icmp", 6: "tcp", 17: "udp"},
    "signal_source": {0: "packet", 1: "xflow", 3: "ebpf", 4: "otel"},
}

FLOW_TAG_DB = "flow_tag"

# -- datasource tier selection ------------------------------------
# The rollup cascade maintains bounded 1m/1h tiers alongside the 1s
# tables; the datasource manager materializes more. A range query whose
# step is coarse should read the COARSEST tier whose resolution
# satisfies the step instead of replaying 1s rows — a month at 1h
# resolution is ~720 tier rows per series, not 2.6M second rows. The
# querier routes a BARE family name ("network") through here; an
# explicit granularity ("network.1s") stays pinned.

TIER_SUFFIX_S = {"1s": 1, "1m": 60, "1h": 3600, "1d": 86400}


def select_datasource_tier(
    available: dict[str, int], step: int | None,
    live_tables: frozenset[str] | set[str] = frozenset(),
) -> str | None:
    """Pick a table from `available` ({table_name: interval_s}).

    The coarsest tier whose interval both fits within and divides
    `step` wins (divisibility keeps output buckets aligned with tier
    rows — a 90s step over a 1m tier would split tier rows across
    buckets). step None (no interval grouping) reads the finest tier:
    detail queries must not silently coarsen. A step FINER than every
    available tier returns None — answering a 30s-bucket query from
    60s rows would produce a silently wrong series, so the caller's
    no-such-table error is the correct outcome.

    `live_tables`: tables with a registered open-window live
    source. When the query's range touches the open span (the engine
    only passes a non-empty set then), a LIVE-covered tier that
    satisfies the step beats a coarser tier without coverage — the
    coarser rows would silently miss the freshest `delay` seconds that
    the live overlay exists to serve. Among live-covered fits the
    FINEST wins (it has the freshest open windows)."""
    if not available:
        return None
    by_interval = sorted(available.items(), key=lambda kv: kv[1])
    if step is None:
        return by_interval[0][0]
    if by_interval[0][1] > step:
        return None  # even the finest tier is coarser than the step
    fits = [
        (name, s) for name, s in by_interval if s <= step and step % s == 0
    ]
    if fits and live_tables:
        live_fits = [(name, s) for name, s in fits if name in live_tables]
        if live_fits:
            return live_fits[0][0]
    return (fits[-1] if fits else by_interval[0])[0]


class Translator:
    def __init__(self, store):
        self.store = store
        self._cache: dict[str, dict[int, str]] = {}

    def _load_map(self, kind: str) -> dict[int, str]:
        m = self._cache.get(kind)
        if m is not None:
            return m
        m = {}
        table = f"{kind}_map"
        try:
            cols = self.store.scan(FLOW_TAG_DB, table, columns=["id", "name"])
            m = {int(i): str(s) for i, s in zip(cols["id"], cols["name"])}
        except KeyError:
            pass  # dictionary not materialized (no controller) → ids pass through
        self._cache[kind] = m
        return m

    def invalidate(self, kind: str | None = None) -> None:
        if kind is None:
            self._cache.clear()
        else:
            self._cache.pop(kind, None)

    # ch_pod_k8s_label / _annotation / _env lookups — the
    # `k8s.label.<key>` custom-tag seat (tag/translation.go dictGet on
    # flow_tag.pod_k8s_label_map)
    _K8S_TABLES = {
        "label": "pod_k8s_label_map",
        "annotation": "pod_k8s_annotation_map",
        "env": "pod_k8s_env_map",
    }

    def _load_kv(self, table: str) -> dict[tuple[int, str], str]:
        cache_key = f"kv:{table}"
        m = self._cache.get(cache_key)
        if m is not None:
            return m
        m = {}
        try:
            cols = self.store.scan(FLOW_TAG_DB, table, columns=["id", "key", "value"])
            m = {
                (int(i), str(k)): str(v)
                for i, k, v in zip(cols["id"], cols["key"], cols["value"])
            }
        except KeyError:
            pass
        self._cache[cache_key] = m
        return m

    def k8s_meta(self, kind: str, key: str, pod_ids: np.ndarray) -> np.ndarray:
        """Pod ids → the value of one label/annotation/env key ('' when
        absent)."""
        table = self._K8S_TABLES[kind]
        m = self._load_kv(table)
        return np.array([m.get((int(v), key), "") for v in pod_ids])

    def translate(self, table: str, column: str, ids: np.ndarray) -> np.ndarray:
        base = column[:-2] if column.endswith(("_0", "_1")) else column
        if base in _ENUMS:
            enum = _ENUMS[base]
            return np.array([enum.get(int(v), str(int(v))) for v in ids])
        kind = _COLUMN_DICT.get(base)
        if kind is None:
            return np.array([str(int(v)) for v in ids])
        m = self._load_map(kind)
        return np.array([m.get(int(v), str(int(v))) for v in ids])
