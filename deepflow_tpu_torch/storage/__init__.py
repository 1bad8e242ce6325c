"""Columnar telemetry store — the ClickHouse seat in the reference.
Port copy of deepflow_tpu/storage/__init__.py.

`store.py` is the table/partition engine (ckdb analog), `writer.py` the
batched ingest writer (ckwriter analog), `flow_tag.py` the SmartEncoding
sidecar dictionaries.
"""

from .store import ColumnarStore, ColumnSpec, TableSchema, org_db
from .writer import TableWriter

__all__ = ["ColumnarStore", "ColumnSpec", "TableSchema", "TableWriter", "org_db"]
