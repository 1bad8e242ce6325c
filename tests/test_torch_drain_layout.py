"""The flush drain's column-blocked row fetch (stash.pack_flush_blocks)
and its slicing split (WindowManager._split_rows) against the row-major
layout they replace: a row-major fetch of the packed [n, 3+T+M] rows,
`unpack_flush_rows` and a scan of every row for the window bounds. Each
configuration runs twice on the same stream, once as the program stands
and once with those three swapped back in, and every FlushedWindow,
DocBatch, sketch block, tier window and live snapshot must be the same
bits, with the same fetches and bytes a call. The `cuda` test at the end
runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_drain_layout.py

This file imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepflow_tpu_torch.aggregator import window as window_mod
from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig, SketchConfig
from deepflow_tpu_torch.aggregator.stash import (
    FLUSH_META_COLS,
    pack_flush_blocks,
    unpack_flush_blocks,
    unpack_flush_rows,
)
from deepflow_tpu_torch.aggregator.window import FlushedWindow, WindowConfig, WindowManager
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.utils.spans import SPAN_FLUSH_COPY, SpanTracer

T0 = 1_700_000_000
_SK = dict(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256, topk_rows=2,
           topk_cols=64, pending=8, hist=LogHistSpec(bins=32, vmin=1.0, gamma=1.3))
# event seconds of the calls: closes one or more windows at a time, and
# (cascade) two 1 m tier windows
SECONDS = [0, 1, 1, 2, 3, 5, 6, 6, 9, 10, 61, 62, 65, 125, 126]

CASES = {
    "exact": dict(window=dict(capacity=1 << 12)),
    # a stash too small for the stream: the newest windows' rows shed, so
    # some windows close sketch-only
    "slab_sketch": dict(window=dict(capacity=192, sketch=SketchConfig(**_SK))),
    "pool_sketch": dict(window=dict(capacity=1 << 12,
                                    sketch=SketchConfig(**_SK, pool=PoolConfig()))),
    "cascade": dict(window=dict(capacity=1 << 12,
                                cascade=CascadeConfig(intervals=(60,), capacity=1 << 12))),
    "snapshot": dict(window=dict(capacity=1 << 12, sketch=SketchConfig(**_SK),
                                 min_snapshot_interval=0.0), snapshot=True),
}


# -- the row-major layout this PR's layout replaced ---------------------------
def _row_major_pack(packed, total, num_tags, tail=()):
    return torch.cat([packed[:total].reshape(-1)] + [t.reshape(-1) for t in tail])


def _row_major_unpack(flat, total, num_tags, row_cols):
    n = total * row_cols
    return (*unpack_flush_rows(flat[:n].reshape(total, row_cols), num_tags), n)


def _row_scan_split(self, win, key_hi, key_lo, tags, meters, *, partial=False):
    total = win.shape[0]
    if total == 0:
        return []
    bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1]]).tolist() + [total]
    return [FlushedWindow(window_idx=int(win[a]), start_time=int(win[a]) * self.config.interval,
                          key_hi=key_hi[a:b], key_lo=key_lo[a:b], tags=tags[a:b],
                          meters=meters[a:b], count=b - a, partial=partial)
            for a, b in zip(bounds, bounds[1:])]


# -- one run ------------------------------------------------------------------
def _run(case: dict, device="cpu", seconds=SECONDS):
    """Replay the stream through an L4Pipeline; returns what it closed,
    read, and fetched, call by call."""
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(**case["window"]), batch_size=256,
                                     batch_unique_cap=256), device=device)
    windows = []
    drain = pipe.wm._drain_ready

    def recording(ready):
        out = drain(ready)
        windows.extend(out)
        return out

    pipe.wm._drain_ready = recording
    gen = SyntheticFlowGen(num_tuples=300, seed=7)
    got = {"docs": [], "fetches": [], "snapshots": []}
    for t in seconds:
        c0 = pipe.get_counters()
        got["docs"] += pipe.ingest(gen.flow_batch(200, T0 + t))
        if case.get("snapshot"):
            got["snapshots"].append(pipe.snapshot_open(force=True).windows)
        c1 = pipe.get_counters()
        got["fetches"].append((c1["host_fetches"] - c0["host_fetches"],
                               c1["bytes_fetched"] - c0["bytes_fetched"]))
    got["docs"] += pipe.drain()
    got["windows"] = windows
    got["sketches"] = pipe.pop_closed_sketches()
    got["tiers"] = pipe.pop_tier_windows()
    got["pipe"] = pipe
    return got


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _same_block(a, b) -> bool:
    if a is None or b is None:
        return a is b
    scalars = (a.window, a.n_updates) == (b.window, b.n_updates)
    fields = ("hll", "cms", "hist", "tk_hi", "tk_lo", "tk_ida", "tk_idb", "tk_votes")
    return scalars and all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)


def _same_window(a: FlushedWindow, b: FlushedWindow) -> bool:
    head = ("window_idx", "start_time", "count", "tier", "interval", "partial")
    return (all(getattr(a, f) == getattr(b, f) for f in head)
            and all(np.array_equal(_bits(getattr(a, f)), _bits(getattr(b, f)))
                    for f in ("key_hi", "key_lo", "tags", "meters"))
            and _same_block(a.sketches, b.sketches))


def _same_windows(xs, ys) -> bool:
    return len(xs) == len(ys) and all(_same_window(a, b) for a, b in zip(xs, ys))


@pytest.mark.parametrize("name", list(CASES))
def test_column_blocks_split_to_the_row_major_split(monkeypatch, name):
    case = CASES[name]
    new = _run(case)
    with monkeypatch.context() as m:
        m.setattr(window_mod, "pack_flush_blocks", _row_major_pack)
        m.setattr(window_mod, "unpack_flush_blocks", _row_major_unpack)
        m.setattr(WindowManager, "_split_rows", _row_scan_split)
        old = _run(case)
    rows = [f for f in new["windows"] if f.count]
    assert rows and len(new["docs"]) >= len(rows)
    assert _same_windows(new["windows"], old["windows"])
    assert len(new["docs"]) == len(old["docs"])
    for a, b in zip(new["docs"], old["docs"]):
        assert np.array_equal(a.tags, b.tags)
        assert np.array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))
        assert np.array_equal(a.timestamp, b.timestamp)
    assert len(new["sketches"]) == len(old["sketches"])
    assert all(_same_block(a, b) for a, b in zip(new["sketches"], old["sketches"]))
    assert _same_windows(new["tiers"], old["tiers"])
    assert len(new["snapshots"]) == len(old["snapshots"])
    assert all(_same_windows(a, b) for a, b in zip(new["snapshots"], old["snapshots"]))
    # the same single row fetch a drain: fetches and bytes, call by call
    assert new["fetches"] == old["fetches"]
    # the slices are the blocks' own rows, no copies
    for f in rows + [w for snap in new["snapshots"] for w in snap if w.count]:
        for a in (f.key_hi, f.key_lo, f.tags, f.meters):
            assert a.flags.c_contiguous and not a.flags.owndata
    for db in new["docs"]:
        assert db.tags.flags.c_contiguous and db.meters.flags.c_contiguous
    # what each case exists to reach
    if name == "slab_sketch":
        assert any(f.count == 0 and f.sketches is not None for f in new["windows"])
    if name in ("slab_sketch", "pool_sketch", "snapshot"):
        assert new["sketches"]
    if name == "cascade":
        assert any(f.count for f in new["tiers"])
    if name == "snapshot":
        assert any(w.count for snap in new["snapshots"] for w in snap)
    # nothing lands page-locked on the CPU, and flush.copy reports none
    assert new["pipe"].wm.pinned_fetches == 0
    assert "pinned" not in new["pipe"].tracer.summary()[SPAN_FLUSH_COPY]


@pytest.mark.parametrize("total", [0, 1, 37])
def test_pack_flush_blocks_lays_out_the_columns_then_the_tail(total):
    t_tags, m_meters = 5, 4
    cols = FLUSH_META_COLS + t_tags + m_meters
    g = torch.Generator().manual_seed(total)
    packed = torch.randint(-2**31, 2**31 - 1, (64, cols), generator=g, dtype=torch.int32)
    packed[:total, 0] = torch.sort(torch.randint(0, 4, (total,), generator=g)).values
    tail = [torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor([7], dtype=torch.int32)]
    flat = pack_flush_blocks(packed, total, t_tags, tail).numpy().view(np.uint32)
    rows = packed[:total].numpy().view(np.uint32)
    win, hi, lo, tags, meters, o = unpack_flush_blocks(flat, total, t_tags, cols)
    assert flat.size == total * cols + 7 and o == total * cols
    assert np.array_equal(win, rows[:, 0]) and np.array_equal(hi, rows[:, 1])
    assert np.array_equal(lo, rows[:, 2])
    assert np.array_equal(tags, rows[:, 3:3 + t_tags])
    assert np.array_equal(meters.view(np.uint32), rows[:, 3 + t_tags:])
    assert meters.dtype == np.float32 and meters.shape == (total, m_meters)
    assert all(a.flags.c_contiguous for a in (win, hi, lo, tags, meters))
    assert np.array_equal(flat[o:], [0, 1, 2, 3, 4, 5, 7])


def test_a_span_counts_the_landings_it_reports():
    tr = SpanTracer()
    for pinned in (1, None, 1):
        with tr.span(SPAN_FLUSH_COPY) as sp:
            sp.bytes, sp.pinned = 8, pinned
    with tr.span("other"):
        pass
    s = tr.summary()
    assert (s[SPAN_FLUSH_COPY]["count"], s[SPAN_FLUSH_COPY]["pinned"]) == (3, 2)
    assert "pinned" not in s["other"]
    assert tr.get_counters()[f"{SPAN_FLUSH_COPY}.pinned"] == 2


# -- the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked host memory is the card's")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_the_card_lands_every_row_fetch_page_locked(cuda):
    case = {"window": dict(capacity=1 << 12, sketch=SketchConfig(**_SK))}
    seconds = list(range(24))
    card, host = _run(case, device=cuda, seconds=seconds), _run(case, seconds=seconds)
    assert len(card["docs"]) == len(host["docs"]) > 8
    for a, b in zip(card["docs"], host["docs"]):
        assert np.array_equal(a.tags, b.tags) and np.array_equal(a.meters, b.meters)
    wm, copy = card["pipe"].wm, card["pipe"].tracer.summary()[SPAN_FLUSH_COPY]
    assert wm.pinned_fetches == copy["count"] == copy["pinned"] > 0
    assert wm.pinned_bytes == copy["bytes"]

    # returned batches stay whole while later drains run, and after the
    # warm-up no drain takes a new page-locked block
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(**case["window"]), batch_size=256,
                                     batch_unique_cap=256), device=cuda)
    gen = SyntheticFlowGen(num_tuples=300, seed=7)
    held = []
    for t in range(6):
        held += pipe.ingest(gen.flow_batch(200, T0 + t))
    assert held
    copies = [(db.tags.copy(), db.meters.copy()) for db in held]
    # two more calls whose batches are let go: the previous call's batch
    # is still alive while the next drain lands
    for t in range(6, 8):
        out = pipe.ingest(gen.flow_batch(200, T0 + t))
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    for t in range(8, 16):
        out = pipe.ingest(gen.flow_batch(200, T0 + t))
        assert out
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    for db, (tags, meters) in zip(held, copies):
        assert np.array_equal(db.tags, tags) and np.array_equal(db.meters, meters)
