"""Straight-line NumPy/dict oracle for the flow-log minute merge.

Port copy of deepflow_tpu/flowlog/oracle.py.

Re-implements minute_merge's per-flow sequential fold (flow_aggr.rs:216)
with Python dicts and exact integer arithmetic, applying each LogSchema
column's merge class in arrival order. Conformance tests replay identical
batches through MinuteAggr (device) and this oracle and assert equal
rows — same role as oracle/numpy_oracle.py for the metrics stash.
"""

from __future__ import annotations

from .aggr import FlowLogBatch
from .schema import LogOp, LogSchema


def minute_merge_oracle(schema: LogSchema, batches: list[FlowLogBatch]) -> dict:
    """→ {(minute, key_tuple): {col: value}} — exact fold in arrival order."""
    out: dict = {}
    for batch in batches:
        for row in batch.to_rows():
            minute = int(row["end_time"]) // 60
            key = (minute,) + tuple(int(row[k]) for k in schema.key)
            cur = out.get(key)
            if cur is None:
                out[key] = {
                    f.name: row[f.name] for f in schema.ints + schema.nums
                }
                continue
            for f in schema.ints:
                v = int(row[f.name])
                if f.op is LogOp.FIRST:
                    pass
                elif f.op is LogOp.LAST:
                    cur[f.name] = v
                elif f.op is LogOp.MIN:
                    cur[f.name] = min(cur[f.name], v)
                elif f.op is LogOp.MAX:
                    cur[f.name] = max(cur[f.name], v)
                elif f.op is LogOp.OR:
                    cur[f.name] = cur[f.name] | v
            for f in schema.nums:
                v = float(row[f.name])
                if f.op is LogOp.SUM:
                    cur[f.name] = cur[f.name] + v
                else:  # MAX
                    cur[f.name] = max(cur[f.name], v)
    return out


def batches_to_dict(schema: LogSchema, batches: list[FlowLogBatch]) -> dict:
    """Flushed device output → same {(minute, key): cols} shape."""
    out: dict = {}
    for batch in batches:
        for row in batch.to_rows():
            minute = int(row["end_time"]) // 60
            key = (minute,) + tuple(int(row[k]) for k in schema.key)
            assert key not in out, f"duplicate merged row {key}"
            out[key] = {f.name: row[f.name] for f in schema.ints + schema.nums}
    return out
