"""Port parity for the live read plane (`snapshot_open`).

The same seeded SyntheticFlowGen stream goes through the JAX package's
L4Pipeline (CPU backend) and the port's on the CPU, at the shapes of
tests/test_live_read.py (batch 256, stash 2^12), and must come out
bit-equal:

  * a snapshot of a quiesced window equals its later flush, row for row
    (tests/test_live_read.py:68), and the reference's snapshot;
  * interleaved snapshots never perturb the stream, full and merge fold,
    with and without a K = 4 counter ring (tests/test_live_read.py:95);
    each snapshot's windows equal the reference's;
  * the open sketch blocks attached to a snapshot, slab plane and pooled
    memory — the pool's combo rows read from a compact slot and, after
    the promotion, from a wide one;
  * counter-block lanes 16–17, the snapshot_* counters, the rate-limit
    cache and `seq`, the empty-manager snapshot, ≤ 2 fetches a read.

The port has no jit, so `jit_retraces` is not asserted.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch

from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import sketchplane as ref_sp
from deepflow_tpu.datamodel.batch import FlowBatch as RefFlowBatch
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch.aggregator import pipeline, sketchplane, window
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32
from tests.test_torch_sketch_plane import _assert_blocks_equal, _record_blocks

torch.set_num_threads(1)

T0 = 1_700_000_000

_SK = dict(num_groups=4, hll_precision=8, cms_depth=3, cms_width=512, topk_rows=2,
           topk_cols=128, pending=10)
_HIST = dict(bins=64, vmin=1.0, gamma=1.2)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=16, topk_factor=4, hist_factor=8,
             promote_fill=0.5)


def _pipes(sketch: str | None = None, **wkw):
    """(reference, port) L4Pipelines of one window config (stash 2^12, no
    snapshot rate limit unless given), with the slab or pooled plane."""
    wkw = {"capacity": 1 << 12, "min_snapshot_interval": 0.0, **wkw}
    r_sk = p_sk = None
    if sketch is not None:
        pool = sketch == "pool"
        r_sk = ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), **_SK,
                                   pool=ref_sp.PoolConfig(**_POOL) if pool else None)
        p_sk = sketchplane.SketchConfig(hist=LogHistSpec(**_HIST), **_SK,
                                        pool=sketchplane.PoolConfig(**_POOL) if pool else None)
    ref = ref_pipeline.L4Pipeline(ref_pipeline.PipelineConfig(
        window=ref_pipeline.WindowConfig(sketch=r_sk, **wkw), batch_size=256))
    port = pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=window.WindowConfig(sketch=p_sk, **wkw), batch_size=256), device="cpu")
    return ref, port


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def _db_sig(db):
    return (int(db.timestamp[0]), db.size, db.tags.tobytes(), db.meters.tobytes())


def _win_sig(f):
    return (f.window_idx, f.start_time, f.count, f.key_hi.tobytes(), f.key_lo.tobytes(),
            f.tags.tobytes(), f.meters.tobytes())


def _assert_snapshots_equal(a, b, label=""):
    """Reference vs port OpenSnapshot: seq, span start, every window's
    rows bit for bit, partial flags and sketch blocks."""
    assert (a.seq, a.open_from) == (b.seq, b.open_from), label
    assert [_win_sig(w) for w in a.windows] == [_win_sig(w) for w in b.windows], label
    assert all(w.partial for w in b.windows), label
    for x, y in zip(a.windows, b.windows):
        _assert_blocks_equal(x.sketches, y.sketches, f"{label} window {x.window_idx}")


def test_snapshot_of_quiesced_window_equals_later_flush():
    """All of a window's rows ingested → snapshot → advance: the snapshot
    rows ARE the flushed rows, bit-exact including order; the snapshot
    equals the reference's."""
    ref, port = _pipes()
    gen = RefFlowGen(num_tuples=200, seed=3)
    for i in range(3):
        records = gen.records(128, T0 + i)
        ref.ingest(RefFlowBatch.from_records(records))
        port.ingest(FlowBatch.from_records(records))
    r_snap, snap = ref.snapshot_open(), port.snapshot_open()
    _assert_snapshots_equal(r_snap, snap, "quiesced")
    by_win = {w.window_idx: w for w in snap.windows}
    assert by_win and snap.open_from == T0 and snap.seq == 1
    # jump far enough that every snapshotted window closes
    n = 1
    jump = (from_numpy_u32(np.asarray([T0 + 50], np.uint32), "cpu"),
            *(torch.zeros(1, dtype=torch.int64) for _ in range(2)),
            torch.zeros((TAG_SCHEMA.num_fields, n), dtype=torch.int64),
            torch.zeros((FLOW_METER.num_fields, n)), torch.ones(n, dtype=torch.bool))
    closed = {f.window_idx: f for f in port.wm.ingest(*jump) if f.count}
    assert set(by_win) <= set(closed)
    for w, s in by_win.items():
        assert not closed[w].partial and s.partial
        assert _win_sig(closed[w]) == _win_sig(s), w


@pytest.mark.parametrize("fold_mode", ["full", "merge"])
@pytest.mark.parametrize("stats_ring", [1, 4])
def test_snapshot_interleaving_never_perturbs_the_stream(fold_mode, stats_ring):
    """Seeded fuzz (tests/test_live_read.py:95): port streams with and
    without interleaved snapshots emit identical DocBatches and stream
    counters; each snapshot equals the reference's at the same point, the
    reference's DocBatches equal the port's, and the overlay rule
    (flushed supersedes a window's partials) reproduces the oracle."""
    rng = np.random.default_rng(1234 + stats_ring)
    gen = RefFlowGen(num_tuples=300, seed=7)
    ref, live = _pipes(fold_mode=fold_mode, stats_ring=stats_ring, delay=3)
    oracle = _pipes(fold_mode=fold_mode, stats_ring=stats_ring, delay=3)[1]
    t = T0
    out_ref, out_live, out_oracle, last_snapshot = [], [], [], {}
    for step in range(14):
        # random walk with occasional multi-window jumps and a stall
        t += int(rng.choice([0, 1, 1, 2, 7]))
        fb = gen.flow_batch(int(rng.integers(16, 200)), t)
        out_ref += [_db_sig(d) for d in ref.ingest(fb)]
        out_live += [_db_sig(d) for d in live.ingest(_port_batch(fb))]
        out_oracle += [_db_sig(d) for d in oracle.ingest(_port_batch(fb))]
        if rng.random() < 0.5:
            snap = live.snapshot_open(force=True)
            _assert_snapshots_equal(ref.snapshot_open(force=True), snap, f"step {step}")
            last_snapshot = {w.window_idx: w for w in snap.windows}
    out_ref += [_db_sig(d) for d in ref.drain()]
    out_live += [_db_sig(d) for d in live.drain()]
    out_oracle += [_db_sig(d) for d in oracle.drain()]
    assert out_live == out_oracle == out_ref and out_live
    cl, co, cr = live.get_counters(), oracle.get_counters(), ref.get_counters()
    for k in ("doc_in", "flushed_doc", "drop_before_window", "stash_evictions"):
        assert cl[k] == co[k] == cr[k], k
    for k in ("snapshot_reads", "snapshot_bytes", "device_snapshot_reads",
              "device_snapshot_bytes", "host_fetches"):
        assert cl[k] == cr[k], k
    assert cl["snapshot_reads"] > 0 and co["snapshot_reads"] == 0
    flushed_by_start = {sig[0]: sig for sig in out_oracle}
    merged = {w: ("partial", s.count) for w, s in last_snapshot.items()}  # interval 1
    for sig in out_live:
        merged[sig[0]] = sig  # flushed replaces any partial for its window
    assert merged == flushed_by_start


@pytest.mark.parametrize("sketch", ["slab", "pool"])
def test_open_sketch_blocks_bit_equal(sketch):
    """A snapshot after every ingest with the sketch plane on (K = 4 ring;
    the merge fold with the pool): windows and their open sketch blocks
    equal the reference's; the blocks are the plane's open slots. With the
    pool the combo rows are read from compact slots and, after the
    promotion, from a wide slot."""
    ref, port = _pipes(sketch, stats_ring=4,
                       fold_mode="merge" if sketch == "pool" else "full")
    gen = RefFlowGen(num_tuples=2000, seed=7)
    sides, windows = set(), 0
    for i, dt in enumerate([0, 0, 0, 1, 1, 2, 3, 4, 4, 5, 6, 7]):
        fb = gen.flow_batch(256, T0 + dt)
        ref.ingest(fb)
        port.ingest(_port_batch(fb))
        snap = port.snapshot_open(force=True)
        _assert_snapshots_equal(ref.snapshot_open(force=True), snap, f"ingest {i}")
        # the blocks are the plane's open slots: under the ring the host
        # span lags the device gate, so older windows come without one
        sk = port.wm.sk
        open_w = {w for w in sk.win.tolist() if w != sketchplane.SENTINEL_WIN}
        have = {w.window_idx for w in snap.windows if w.sketches is not None}
        assert have <= open_w and (have or not snap.windows)
        windows += len(have)
        if sketch == "pool":
            pc = sk.p_hll.shape[0]
            sides |= {"wide" if s >= pc else "compact" for s in sk.slot_of.tolist() if s >= 0}
    assert windows >= 16
    if sketch == "pool":
        assert sides == {"compact", "wide"}
        assert port.get_counters()["sketch_promotions"] > 0


def test_snapshot_lanes_counters_cache_and_seq(monkeypatch):
    """Counter-block lanes 16–17 carry the snapshot reads and bytes into
    the next dispatch and equal the reference's; an empty manager's
    snapshot counts a read with no fetch; within min_snapshot_interval
    the cached snapshot returns with its seq and no fetch, force=True
    reads anew; every read takes ≤ 2 fetches."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    ref, port = _pipes(min_snapshot_interval=3600.0)
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    empty = port.snapshot_open()
    assert ref.snapshot_open().windows == empty.windows == [] and empty.open_from is None
    assert counts["n"] == 0 and port.get_counters()["snapshot_reads"] == 1
    assert port.snapshot_open() is empty  # cached: same object, same seq
    gen = RefFlowGen(num_tuples=200, seed=5)
    want = []  # the [reads, bytes] each dispatch's block must carry
    for i, dt in enumerate([0, 1, 1, 2, 4, 5]):
        fb = gen.flow_batch(200, T0 + dt)
        c = port.get_counters()
        want.append([c["snapshot_reads"], c["snapshot_bytes"]])
        ref.ingest(fb)
        port.ingest(_port_batch(fb))
        if i % 2:
            before = counts["n"]
            snap = port.snapshot_open(force=True)
            assert counts["n"] - before <= 2
            _assert_snapshots_equal(ref.snapshot_open(force=True), snap, f"ingest {i}")
            before = counts["n"]
            assert port.snapshot_open() is snap and counts["n"] == before
    ref.drain()
    port.drain()
    assert r_blocks == p_blocks
    c = port.get_counters()
    assert c["snapshot_reads"] == 4 == port.wm.snapshot_seq
    assert c["snapshot_bytes"] == ref.get_counters()["snapshot_bytes"] > 0
    lanes = [b[window.CB_SNAPSHOT_READS:window.CB_SNAPSHOT_BYTES + 1] for b in p_blocks]
    assert lanes == want and lanes[0] == [1, 0] and lanes[-1][1] > 0
    assert [c["device_snapshot_reads"], c["device_snapshot_bytes"]] == lanes[-1]
