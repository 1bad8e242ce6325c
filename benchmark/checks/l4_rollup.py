"""The comparison that decides a run's `correct` for a rollup pipeline
(`deepflow_tpu_torch.aggregator.pipeline.RollupPipeline` with the L4
fanout), and the traced calls' work counts.

Compared, once the window has closed and the pipeline is freed:

  * a sample of the windows closed in the window (reservoir, drawn from
    the seed) and every window `drain()` closed, document for document
    against the reference (`reference.compare_docs`), with each closed
    window's sketch block where the plane is on (`sketch_ref`);
  * that every call in the window closed exactly one window;
  * the counter lanes against the counts the replayed records imply:
    documents in and flushed, late drops, pre-reduce, stash and sketch
    sheds, sketch rows.

Each number has a limit in the configuration's `limits` (0 where it
names none); the run is correct when every number is within its limit.
The window, sketch and size settings are read from the configuration's
pipeline spec, with the cell's sizing merged in.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import reference as R
from .. import work as W


def settings(config: dict) -> tuple[dict, dict, dict | None]:
    """(pipeline config, window config, sketch config or None) of a
    configuration's pipeline spec."""
    pipe = config["pipeline"]["config"]
    window = pipe["window"]
    return pipe, window, window.get("sketch")


def collect(run) -> None:
    """Keep the closed windows' sketch blocks, by window (called after
    every call, outside its timing, and after the drain)."""
    for blk in run.pipe.pop_closed_sketches():
        run.blocks[blk.window] = blk


def _merge(acc: dict, new: dict) -> None:
    for k, v in new.items():
        acc[k] = max(acc.get(k, v), v) if k.endswith("_gap") else acc.get(k, 0) + v


def batch_facts(run) -> list[dict]:
    """Per pool batch: valid document rows after the pre-reduce, distinct
    raw records, and the largest lateness of its records."""
    if getattr(run, "_facts", None) is None:
        facts = []
        for b in range(run.stream.pool):
            docs, raw = R.docs_of_batch(run.stream, b)
            _, _, late = run.stream.batch(b)
            facts.append({"docs": docs, "raw": raw, "late": int(late.max())})
        run._facts = facts
    return run._facts


def expected_counters(run, window_docs) -> dict:
    """The counter values the replayed records imply (None where the
    reference cannot state one: the configuration would shed)."""
    stream = run.stream
    pipe, window, sketch = settings(run.spec.config)
    facts = batch_facts(run)
    per = [facts[stream.pool_of(k)] for k in range(run.k)]
    interval, delay = window["interval"], window["delay"]
    bounds = [(stream.time_of(k) - f["late"], stream.time_of(k)) for k, f in enumerate(per)]
    late_free = all(b[0] // interval >= s["gate"]
                    for b, s in zip(bounds, R.window_schedule(bounds, delay, interval)))
    ring = delay // interval + 2
    fits = int(window["capacity"]) >= ring * max(window_docs.values())
    cap_u = int(pipe["batch_unique_cap"])
    out = {
        "doc_in": sum(f["docs"] for f in per),
        "flushed_doc": sum(window_docs.values()),
        "drop_before_window": 0 if late_free else None,
        "prereduce_dropped": sum(max(0, f["raw"] - cap_u) for f in per),
        "drop_overflow": 0 if fits else None,
        "stash_evictions": 0 if fits else None,
    }
    if sketch:
        out["sketch_rows"] = sum(f["raw"] for f in per)
        out["sketch_shed"] = 0
    return out


def _window_key(stream, w: int, last: int):
    """Windows whose batches were all handed in hold, for one residue of
    their first batch mod the pool, the same keys: one reference window
    stands for all of them."""
    k = w - stream.start_time
    if 0 <= k and k + stream.max_late <= last:
        return ("full", k % stream.pool)
    return ("edge", w)


def all_window_docs(run, counted: dict) -> dict:
    """Document count of every window the replay filled, first to last."""
    stream = run.stream
    t0, last = stream.start_time, run.k - 1
    out = {}
    for w in range(t0 - stream.max_late, t0 + last + 1):
        key = _window_key(stream, w, last)
        if key not in counted:
            counted[key] = R.rollup(R.window_parts(stream, w, last)).tags.shape[0]
        out[w] = counted[key]
    return out


def check_run(run) -> dict:
    """Compare the run's output with the reference; returns {"correct",
    "checks": {name: {"value", "limit"}}, "windows": compared ids}."""
    stream = run.stream
    last = run.k - 1
    t0 = stream.start_time
    _, window, sketch = settings(run.spec.config)
    interval = window["interval"]
    numbers = {"docs_unmatched": 0, "nonkey_mismatch": 0, "max_mismatch": 0,
               "sum_exact_mismatch": 0, "sum_rel_gap": 0.0}
    counted = {}
    if sketch:
        from .. import sketch_ref
    drained = {ts // interval: db for ts, db in run.drained}
    compared = [(ts // interval, db) for ts, db in run.sample]
    # every window open at the end must come out of drain()
    for w in range(max(t0 - stream.max_late, t0 + last - window["delay"]), t0 + last + 1):
        compared.append((w, drained.pop(w, None)))
    numbers["docs_unmatched"] += sum(db.size for db in drained.values())
    for w, db in compared:
        parts = R.window_parts(stream, w, last)
        ref = R.rollup(parts)
        counted[_window_key(stream, w, last)] = ref.tags.shape[0]
        if db is None:
            numbers["docs_unmatched"] += ref.tags.shape[0]
            continue
        _merge(numbers, R.compare_docs(torch.from_numpy(db.tags.astype(np.int64)),
                                       torch.from_numpy(np.ascontiguousarray(db.meters)), ref))
        if sketch:
            _merge(numbers, sketch_ref.compare_block(run.blocks.get(w), sketch, parts))
        del ref
    numbers["windows_missing"] = abs(run.ctx.calls - len(run.ctx.close_ms))
    window_docs = all_window_docs(run, counted)
    expected = expected_counters(run, window_docs)
    for name, want in expected.items():
        got = run.counters.get(name)
        numbers[f"{name}_gap"] = (abs(int(got) - int(want))
                                  if want is not None and got is not None else -1)
    limits = run.spec.config.get("limits", {})
    checks = {}
    correct = True
    for name, value in numbers.items():
        limit = limits.get(name, 0)
        ok = 0 <= value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return {"correct": correct, "checks": checks, "windows": [w for w, _ in compared]}


def traced_work(run) -> dict:
    """Least device seconds of each traced kernel call, in launch order,
    per operation: two segmented reduces per batch (the pre-reduce, then
    the fold) and, with the sketch plane, two fused sketch updates (the
    closing-span phase, which holds no rows in this replay, then the
    new-span phase)."""
    if getattr(run, "_work", None) is not None:
        return run._work
    facts = batch_facts(run)
    pipe, window, sketch = settings(run.spec.config)
    ctx = run.ctx
    m = len(R.S.METER_NAMES)
    seg, skf = [], []
    sk_cells = None
    if sketch:
        from .. import sketch_ref

        sk_cells = [sketch_ref.touched_cells(run.stream, b, sketch)
                    for b in range(run.stream.pool)]
    ring = window["delay"] // window["interval"] + 2
    for i, call in enumerate(ctx.traced):
        f = facts[call["pool_batch"]]
        seg.append(W.least_seconds(
            W.segreduce_bytes(run.stream.rows, m, int(pipe["batch_unique_cap"]), f["raw"]),
            W.segreduce_flops(run.stream.rows, m)))
        # the counter mirrors lag one call: the next call's block carries
        # the fold this call ran, and the stash it left less this flush
        if i + 1 < len(ctx.fold_rows):
            n_live = ctx.fold_rows[i + 1]
            live = ctx.occupancy[i + 1] + call["flushed"]
            seg.append(W.least_seconds(
                W.segreduce_bytes(n_live, m, int(window["capacity"]), live),
                W.segreduce_flops(n_live, m)))
        else:
            seg.append(None)
        if sk_cells is not None:
            hll, cms = sk_cells[call["pool_batch"]]
            skf.append(W.least_seconds(W.sketch_fused_bytes(0, ring, sketch["topk_rows"],
                                                            sketch["topk_cols"], 0, 0)))
            skf.append(W.least_seconds(W.sketch_fused_bytes(f["raw"], ring, sketch["topk_rows"],
                                                            sketch["topk_cols"], hll, cms)))
    run._work = {"segreduce": seg, "sketch_fused": skf if sk_cells is not None else None}
    return run._work
