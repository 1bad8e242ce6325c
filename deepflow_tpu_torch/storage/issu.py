"""In-service schema upgrade (ISSU) — the ckissu seat.

The reference migrates every ClickHouse table's schema on boot through a
versioned list of column adds/renames/retypes (ckissu.go:51,425: each
release carries its delta; the upgrader walks them from the store's
recorded version to current). Same protocol over the columnar store:

  * the store root carries a `schema_version` file;
  * MIGRATIONS is the ordered list of (version, Migration) deltas;
  * `upgrade()` applies every delta newer than the recorded version to
    all matching on-disk tables — updating the persisted TableSchema
    AND rewriting existing parts so old data satisfies the new schema
    (missing columns materialize with defaults; renamed columns carry
    their data over).

In-memory stores (no root) are always at head — create_table writes the
current schema, so upgrade() is a no-op.

Port copy of deepflow_tpu/storage/issu.py.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from pathlib import Path

import numpy as np

from .store import ColumnSpec, ColumnarStore, TableSchema

CURRENT_VERSION = 2


@dataclasses.dataclass(frozen=True)
class AddColumn:
    table_glob: str  # "db/table" glob, e.g. "flow_log/l7_flow_log"
    name: str
    dtype: str
    default: object = 0


@dataclasses.dataclass(frozen=True)
class RenameColumn:
    table_glob: str
    old: str
    new: str


# version → deltas applied when upgrading TO that version. Version 1 is
# the first on-disk layout; version 2 added the trace columns the
# tracing plane introduced (parent_span_id / x_request_id,
# flowlog/schema.py).
MIGRATIONS: list[tuple[int, list]] = [
    (
        2,
        [
            AddColumn("*/l7_flow_log", "parent_span_id", "U256", ""),
            AddColumn("*/l7_flow_log", "x_request_id", "U256", ""),
        ],
    ),
]


def _version_file(root: Path) -> Path:
    return root / "schema_version"


def read_version(root: str | Path) -> int:
    f = _version_file(Path(root))
    if not f.exists():
        return 0
    try:
        return int(f.read_text().strip())
    except ValueError:
        return 0


def upgrade(store: ColumnarStore, target: int = CURRENT_VERSION) -> dict:
    """Apply pending migrations to every on-disk table. Returns a report
    {applied: [version...], tables_changed: N}."""
    root = getattr(store, "root", None)
    if root is None:
        return {"applied": [], "tables_changed": 0}
    root = Path(root)
    if not root.exists():
        root.mkdir(parents=True, exist_ok=True)
    have = read_version(root)
    if have == 0 and not any(root.iterdir()):
        # fresh store: born at head
        _version_file(root).write_text(str(target))
        return {"applied": [], "tables_changed": 0}

    applied, changed = [], 0
    for version, deltas in MIGRATIONS:
        if version <= have or version > target:
            continue
        for delta in deltas:
            changed += _apply(store, delta)
        applied.append(version)
    _version_file(root).write_text(str(target))
    return {"applied": applied, "tables_changed": changed}


def _apply(store: ColumnarStore, delta) -> int:
    changed = 0
    for db in store.databases():
        for table in store.tables(db):
            if not fnmatch.fnmatch(f"{db}/{table}", delta.table_glob):
                continue
            schema = store.schema(db, table)
            if isinstance(delta, AddColumn):
                if delta.name in schema.column_names():
                    continue
                new_schema = TableSchema(
                    schema.name,
                    schema.columns + (ColumnSpec(delta.name, delta.dtype),),
                    partition_s=schema.partition_s,
                )
                _rewrite(store, db, table, new_schema,
                         add={delta.name: (delta.dtype, delta.default)})
            elif isinstance(delta, RenameColumn):
                if delta.old not in schema.column_names():
                    continue
                cols = tuple(
                    ColumnSpec(delta.new, c.dtype) if c.name == delta.old else c
                    for c in schema.columns
                )
                new_schema = TableSchema(schema.name, cols, partition_s=schema.partition_s)
                _rewrite(store, db, table, new_schema,
                         rename={delta.old: delta.new})
            changed += 1
    return changed


def _fix_part(data: dict, add, rename) -> dict:
    n = len(next(iter(data.values()))) if data else 0
    for name, (dtype, default) in (add or {}).items():
        if name not in data:
            data[name] = np.full(n, default, dtype=np.dtype(dtype))
    for old, new in (rename or {}).items():
        if old in data:
            data[new] = data.pop(old)
    return data


def _rewrite(store, db, table, new_schema, add=None, rename=None) -> None:
    """Swap the table's schema and rewrite every part (disk or memory)."""
    t = store._get(db, table)
    with store._lock:
        t.schema = new_schema
        if t.path is not None:
            (t.path / "schema.json").write_text(new_schema.to_json())
        mem_parts = {
            pid: [p for p in ps if not isinstance(p, Path)]
            for pid, ps in t.parts.items()
        }
        disk_parts = [p for ps in t.parts.values() for p in ps if isinstance(p, Path)]
        for ps in mem_parts.values():
            for p in ps:
                _fix_part(p, add, rename)
    for part in disk_parts:
        try:
            data = dict(np.load(part))
        except FileNotFoundError:
            continue
        data = _fix_part(data, add, rename)
        with open(part, "wb") as f:
            np.savez_compressed(f, **data)
