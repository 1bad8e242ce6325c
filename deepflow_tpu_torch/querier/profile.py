"""Flame-graph service — the querier/profile seat.

The reference builds flame trees from `in_process_profile` rows
(server/querier/profile/). `flame_tree` folds stack rows into the
nested {name, self_value, total_value, children} shape flamegraph UIs
consume; `query_flame` runs the scan + filter through the store.

Port copy of deepflow_tpu/querier/profile.py.
"""

from __future__ import annotations

import numpy as np

from ..storage.store import ColumnarStore


def flame_tree(stacks: list[str], values: list[int]) -> dict:
    root = {"name": "root", "self_value": 0, "total_value": 0, "children": {}}
    for stack, value in zip(stacks, values):
        node = root
        node["total_value"] += value
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = node["children"][frame] = {
                    "name": frame,
                    "self_value": 0,
                    "total_value": 0,
                    "children": {},
                }
            child["total_value"] += value
            node = child
        node["self_value"] += value

    def finish(node):
        node["children"] = [finish(c) for c in node["children"].values()]
        return node

    return finish(root)


def query_flame(
    store: ColumnarStore,
    *,
    app_service: str,
    time_range: tuple[int, int] | None = None,
    event_type: str | None = None,
    db: str = "profile",
) -> dict:
    cols = store.scan(db, "in_process_profile", time_range=time_range)
    sel = cols["app_service"] == app_service
    if event_type is not None:
        sel &= cols["profile_event_type"] == event_type
    return flame_tree(
        [str(s) for s in cols["stack"][sel]],
        [int(v) for v in np.asarray(cols["value"])[sel]],
    )
