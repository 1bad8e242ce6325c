"""The sharded L4 pipeline (parallel/sharded.py ShardedL4Pipeline): four
shards on the CPU against the benchmark's plain references
(benchmark/reference.py, benchmark/sketch_ref.py) over records of the
`card_flows` generator, whose cards hold disjoint flows and clients and
share servers (the key space is cut here so that many server-side
document keys are on several cards).

  * every closed window's documents (one row a card for a key on
    several, summed per key as the benchmark's check sums them), the
    merged sketch blocks (HLL, count-min, histogram, top-K as the union
    of the cards' candidates) and the counters summed over shards;
  * the share ties to the whole: the four shards' documents of a window,
    summed per key, equal a single-card `L4Pipeline` on the same records
    and the reference over all of them, and a key on one shard is the
    single card's row;
  * the drain lands through the single card's layout: one column-
    blocked row fetch (`stash.pack_flush_blocks`) split by slicing.

The `cuda` test at the end runs the facade on four cards when four are
visible and holds it to the same facade on the CPU:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_facade.py

This file imports neither JAX nor the JAX package."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark.checks import l4_sharded
from benchmark.generators.card_flows import CardFlowStream
from deepflow_tpu_torch.aggregator import window as window_mod
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.parallel import sharded
from deepflow_tpu_torch.parallel.sharded import ShardedL4Pipeline
from deepflow_tpu_torch.utils.spans import SPAN_FLUSH_COPY, SPAN_SHARD_STEP, SPAN_SHARD_UPLOAD

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 4
CARD_ROWS = 1 << 10
SK = dict(num_groups=8, hll_precision=8, cms_depth=4, cms_width=1 << 10, topk_rows=2,
          topk_cols=64, pending=8)
HIST = dict(bins=64, vmin=1.0, gamma=1.1)
CALLS = 6  # windows 0..5 close; the drain closes the last two


def _mix(**kw) -> dict:
    mix = json.loads((ROOT / "benchmark" / "traffic" / "hicard4x.json").read_text())
    # one VPC, one process id and one port a side: a server-side key is
    # its pod, direction and protocol, so most servers are on several cards
    mix.update(records_per_batch=SHARDS * CARD_ROWS, tuples=SHARDS * 600, pod_ips=SHARDS * 80,
               pool_batches=3, late=[{"seconds": 1, "share": 0.1}], epc_range=[1, 2],
               gpid_range=[0, 1], ports=[80], **kw)
    return mix


def _config(batch: int, capacity: int = 1 << 13) -> PipelineConfig:
    return PipelineConfig(batch_size=batch, batch_unique_cap=CARD_ROWS,
                          window=WindowConfig(interval=1, delay=2, capacity=capacity,
                                              sketch=SketchConfig(**SK, hist=LogHistSpec(**HIST))))


def _replay(pipe, stream) -> dict:
    """Every call of a closed-loop replay, then the drain: the closed
    documents by window, the sketch blocks by window, the counters."""
    pool = [stream.host_batch(b) for b in range(stream.pool)]
    docs, blocks = {}, {}
    for k in range(CALLS):
        hb = pool[stream.pool_of(k)]
        hb.stamp(stream.time_of(k))
        for db in pipe.ingest(hb.as_input()):
            docs[int(db.timestamp[0])] = db
        blocks.update({b.window: b for b in pipe.pop_closed_sketches()})
    for db in pipe.drain():
        docs[int(db.timestamp[0])] = db
    blocks.update({b.window: b for b in pipe.pop_closed_sketches()})
    return {"docs": docs, "blocks": blocks, "counters": pipe.counters, "pipe": pipe}


_RUNS: dict = {}


def _run(name: str = "sharded", device="cpu") -> dict:
    key = (name, str(device))
    if key not in _RUNS:
        stream = CardFlowStream(_mix(), 2**31 + 77, "cpu")
        if name == "sharded":
            pipe = ShardedL4Pipeline(_config(stream.rows), SHARDS, device=device)
        else:  # one card of unlimited memory: the same records, one stash
            cfg = _config(stream.rows, capacity=SHARDS << 13)
            pipe = L4Pipeline(dataclasses.replace(cfg, batch_unique_cap=stream.rows),
                              device=device)
        _RUNS[key] = dict(_replay(pipe, stream), stream=stream)
    return _RUNS[key]


def _rows(db) -> list:
    """A window's documents as a sorted list of (tags, meter bits) rows."""
    return sorted(zip(map(tuple, np.asarray(db.tags).tolist()),
                      map(tuple, np.asarray(db.meters).view(np.uint32).tolist())))


@pytest.mark.parametrize("what", ["documents", "sketches", "counters"])
def test_four_shards_match_the_reference(what):
    run = _run()
    stream, last = run["stream"], CALLS - 1
    windows = sorted(run["docs"])
    assert len(windows) == CALLS + stream.max_late
    _, _, cfg = l4_sharded.settings({"pipeline": {"config": {"window": {"sketch": {
        **SK, "hist": HIST}}}}})
    for w in windows:
        if what == "documents":
            db = run["docs"][w]
            got, _ = l4_sharded.compare_window(
                torch.from_numpy(db.tags.astype(np.int64)),
                torch.from_numpy(np.ascontiguousarray(db.meters)),
                [l4_sharded.card_window(stream.card(c), w, last, None)[0]
                 for c in range(SHARDS)])
            assert got == {"docs_unmatched": 0, "nonkey_mismatch": 0, "max_mismatch": 0,
                           "sum_exact_mismatch": 0, "sum_rel_gap": 0.0}, (w, got)
        elif what == "sketches":
            got = l4_sharded.compare_block(run["blocks"].get(w), l4_sharded.merged_sketch(
                [l4_sharded.card_window(stream.card(c), w, last, cfg)[1] for c in range(SHARDS)]))
            assert got["topk_keys_unmatched"] == 0 and got["sk_updates_gap"] == 0, (w, got)
            assert got["hll_mismatch"] == 0 and got["distinct_rel_gap"] < 0.2, (w, got)
            assert got["cms_rel_gap"] < 1e-3 and got["hist_moved_gap"] < 1e-3, (w, got)
            assert got["topk_vote_gap"] < 1e-3, (w, got)
    if what == "counters":
        c = run["counters"]
        docs = sum(db.size for db in run["docs"].values())
        per = [[R.docs_of_batch(stream.card(d), stream.pool_of(k)) for d in range(SHARDS)]
               for k in range(CALLS)]
        assert c["flushed_doc"] == docs
        assert c["doc_in"] == sum(n for call in per for n, _ in call)
        assert c["sketch_rows"] == sum(raw for call in per for _, raw in call)
        for k in ("drop_before_window", "prereduce_dropped", "drop_overflow",
                  "stash_evictions", "sketch_shed"):
            assert c[k] == 0, k
        assert c["window_advances"] == CALLS - 1 and c["stash_occupancy"] > 0


def _by_key(db) -> dict:
    """A window's rows (`_rows`) grouped by their document key."""
    out: dict = {}
    for row in _rows(db):
        out.setdefault(tuple(row[0][i] for i in R.S.DOC_KEY_INDEX), []).append(row)
    return out


def test_shards_summed_per_key_equal_one_card_and_the_reference():
    """The share ties to the whole: a window's documents from the four
    shards, summed per key, are a single card's documents on the same
    records (keys and meters); a key on one shard is the single card's
    row, non-key tags included; and the cards' references summed per key
    are the reference over all the records."""
    shard_run, one = _run(), _run("single")
    stream, last = shard_run["stream"], CALLS - 1
    assert sorted(shard_run["docs"]) == sorted(one["docs"])
    on_several = 0
    for w, db in shard_run["docs"].items():
        single = one["docs"][w]
        mine = l4_sharded.per_key(torch.from_numpy(db.tags.astype(np.int64)),
                                  torch.from_numpy(np.ascontiguousarray(db.meters)))
        theirs = l4_sharded.per_key(torch.from_numpy(single.tags.astype(np.int64)),
                                    torch.from_numpy(np.ascontiguousarray(single.meters)))
        assert torch.equal(mine.tags[:, list(R.S.DOC_KEY_INDEX)],
                           theirs.tags[:, list(R.S.DOC_KEY_INDEX)]), w
        assert torch.equal(mine.meters, theirs.meters), w
        ones = _by_key(single)
        for key, rows in _by_key(db).items():
            if len(rows) == 1:
                assert rows == ones[key], (w, key)
            else:
                on_several += 1
    assert on_several > 0  # the stream puts server keys on several shards
    for w in (min(shard_run["docs"]) + 2, max(shard_run["docs"])):
        refs = [l4_sharded.card_window(stream.card(c), w, last, None)[0] for c in range(SHARDS)]
        whole = l4_sharded.per_key(torch.cat([r.tags for r in refs]),
                                   torch.cat([r.meters for r in refs]))
        got = R.compare_docs(whole.tags, whole.meters, R.rollup(R.window_parts(stream, w, last)))
        assert got["docs_unmatched"] == got["max_mismatch"] == got["sum_exact_mismatch"] == 0
        assert got["sum_rel_gap"] == 0.0, (w, got)
    for k in ("doc_in", "sketch_rows"):
        assert shard_run["counters"][k] == one["counters"][k], k


def test_the_drain_lands_through_the_single_card_layout(monkeypatch):
    """Each drain with rows is ONE scalar fetch and ONE column-blocked
    row fetch (`pack_flush_blocks`, exact rows, no padding), split by
    `split_rows`; every window's documents view that fetch."""
    packs, splits, fetched = [], [], []
    real_pack, real_split, real_fetch = (window_mod.pack_flush_blocks, sharded.split_rows,
                                         window_mod.host_fetch)
    monkeypatch.setattr(window_mod, "pack_flush_blocks",
                        lambda *a, **k: packs.append(a[1]) or real_pack(*a, **k))
    monkeypatch.setattr(sharded, "split_rows", lambda *a, **k: splits.append(a[0].shape[0])
                        or real_split(*a, **k))

    def counting(x, out=None):
        arr = real_fetch(x) if out is None else real_fetch(x, out)
        fetched.append(arr.nbytes)
        return arr

    monkeypatch.setattr(window_mod, "host_fetch", counting)
    stream = CardFlowStream(_mix(), 5, "cpu")
    pipe = ShardedL4Pipeline(_config(stream.rows), SHARDS, device="cpu")
    hb = stream.host_batch(0)
    row_cols = 3 + pipe.wm.stash[0].tags.shape[0] + pipe.wm.stash[0].meters.shape[0]
    pend_w = pipe.wm.sketches[0].pend.shape[1]
    row_fetches = []
    for k in range(4):
        hb.stamp(stream.time_of(k))
        n0 = len(fetched)
        out = pipe.ingest(hb.as_input())
        if not out:
            assert len(fetched) <= n0 + 1  # at most an advance's scalar fetch
            continue
        assert len(fetched) == n0 + 2  # the scalar fetch, then the rows
        rows = sum(db.size for db in out)
        assert packs[-1] == rows and splits[-1] == rows
        # exactly the rows' u32 columns and each shard's closed sketch
        # blocks with their window ids: no padding, no shard left out
        blocks = len(pipe.pop_closed_sketches())
        assert blocks > 0
        assert fetched[-1] == 4 * (rows * row_cols + SHARDS * blocks * (pend_w + 1))
        base = out[0].tags.base
        assert all(np.shares_memory(db.tags, base) for db in out)
        row_fetches.append(fetched[-1])
    spans = pipe.tracer.summary()
    assert spans[SPAN_SHARD_UPLOAD]["count"] == spans[SPAN_SHARD_STEP]["count"] == 4 * SHARDS
    assert spans[SPAN_FLUSH_COPY]["count"] == len(row_fetches) >= 2
    assert spans[SPAN_FLUSH_COPY]["bytes"] == sum(row_fetches)


# -- the card -----------------------------------------------------------------
@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < SHARDS:
        pytest.skip(f"needs {SHARDS} CUDA cards: the facade places one shard a card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_four_cards_equal_the_cpu_and_land_every_row_fetch_page_locked(cards, monkeypatch):
    synced = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: synced.append(1)
                        or real_sync(*a, **k))
    card = _run(device=cards)
    assert not synced  # the facade adds no synchronize()
    host = _run()
    assert sorted(card["docs"]) == sorted(host["docs"])
    for w, db in card["docs"].items():
        assert _rows(db) == _rows(host["docs"][w]), w
    for k in ("doc_in", "flushed_doc", "sketch_rows", "drop_overflow"):
        assert card["counters"][k] == host["counters"][k], k
    wm = card["pipe"].wm
    copy = card["pipe"].tracer.summary()[SPAN_FLUSH_COPY]
    assert wm.pinned_fetches == copy["count"] == copy["pinned"] > 0
    assert wm.pinned_bytes == copy["bytes"]
    assert [d.index for d in card["pipe"].devices] == list(range(SHARDS))
