"""Port parity for the rollup cascade (1 m / 1 h tiers) and the
dual-granularity pipelines.

The same seeded numpy inputs go through the JAX package (CPU backend)
and the port on the CPU, both starting from the same state through
`convert`, and must come out bit-equal:

  * `tier_step` in each of its branches (append, fold+append, direct
    fold, the degenerate prefix ≥ rows), `tier_ring_fold`, and a
    two-tier `on_advance` chain: every tier-stash lane (dead tail
    included), the ring's slot lane, fill, the [rows, shed] lanes,
    watermarks, TierFlush ranges and flushed rows;
  * `L4Pipeline` / `L7Pipeline` with the cascade on the late-row
    minute-boundary stream of tests/test_cascade.py: 1 s docs, tier
    docs and counter blocks; the hour tier; a tier stash that sheds;
  * the merged tier sketch blocks (slab + full fold, pool + merge
    fold), and the sketch-only tier window of an empty drain;
  * `DualGranularityPipeline` and `DoubleIngestPipeline`: the (flags,
    DocBatch) stream and `coarse_tiers`;
  * ≤ 3 host fetches per ingest with the cascade on; `CascadeConfig`
    validation; the pending-block checkpoint arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import cascade as ref_cascade
from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import stash as ref_stash
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.aggregator.sketchplane import SketchConfig as RefSketchConfig
from deepflow_tpu.datamodel import schema as ref_schema
from deepflow_tpu.datamodel.batch import FlowBatch as RefFlowBatch
from deepflow_tpu.ingest.replay import SyntheticAppGen
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import cascade, pipeline, stash, window
from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig, SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel import schema
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.datamodel.code import DocumentFlag
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

torch.set_num_threads(1)

T0 = 1_700_000_040  # tests/test_cascade.py: 40 s into a minute
SENT = np.uint32(0xFFFFFFFF)
SYNC_BUDGET = 3  # tests/test_perf_gate.py


def _sk(mod_sketch, mod_hist, pool=None):
    """tests/test_cascade.py's small sketch shape, built from either
    package's classes."""
    return mod_sketch(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256,
                      hist=mod_hist(bins=32, vmin=1.0, gamma=1.3), topk_rows=2,
                      topk_cols=64, pending=8, pool=pool)


# The window and tier capacity of every test: the tier-level tests run the
# L4 pipeline's schema and shapes (child 4096, tier 4096, prefix 2048, ring
# 8192), so one reference compile of each tier function serves them and
# every L4 pipeline test. The pipelines' minutes hold ≤ 1,564 rows, the
# overflow stream's first about 8,000.
CAP = 1 << 12
REF_TAGS, REF_METER = ref_schema.TAG_SCHEMA, ref_schema.FLOW_METER
TAGS, METER = schema.TAG_SCHEMA, schema.FLOW_METER
NT, NM = TAGS.num_fields, METER.num_fields
SUM_COLS = tuple(int(i) for i in np.nonzero(REF_METER.sum_mask)[0])
MAX_COLS = tuple(int(i) for i in np.nonzero(REF_METER.max_mask)[0])
CHILD = CAP
RING, PREFIX = cascade.tier_ring_rows(CHILD), cascade.tier_prefix(CHILD)


def _np_state(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _jnp_state(cls, d: dict):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_lanes_equal(want: dict, got: dict, msg: str, lanes=None):
    for k in lanes or want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _assert_ring_equal(want: dict, got: dict, msg: str):
    """An accumulator ring: the slot lane everywhere, the key, tag and
    meter lanes at its live positions (slot != SENTINEL) — the rows the
    next merge reads."""
    _assert_lanes_equal(want, got, msg, lanes=["slot"])
    live = np.asarray(want["slot"]) != SENT
    _assert_lanes_equal({k: np.asarray(want[k])[..., live] for k in RING_LANES},
                        {k: np.asarray(got[k])[..., live] for k in RING_LANES}, f"{msg} live")


RING_LANES = ("key_hi", "key_lo", "tags", "meters")


def _rand_rows(rng, cap, fill, windows, n_keys) -> dict:
    """A ring of `fill` live-ish rows as numpy: random (window, key) pairs
    over `windows` = (lo, hi), non-trivial float bits, ~15% sentinel."""
    slot = np.full(cap, SENT, np.uint32)
    hi, lo = np.zeros(cap, np.uint32), np.zeros(cap, np.uint32)
    tags = np.zeros((NT, cap), np.uint32)
    met = np.zeros((NM, cap), np.float32)
    if fill:
        k = rng.integers(0, n_keys, fill).astype(np.uint32)
        slot[:fill] = rng.integers(*windows, fill).astype(np.uint32)
        hi[:fill], lo[:fill] = k * np.uint32(0x9E3779B1), k * 7 + 1
        tags[:, :fill] = k + np.arange(NT, dtype=np.uint32)[:, None] * 13
        met[:, :fill] = rng.normal(size=(NM, fill)).astype(np.float32)
        slot[:fill][rng.random(fill) < 0.15] = SENT
    return dict(slot=slot, key_hi=hi, key_lo=lo, tags=tags, meters=met)


def _canonical(rng, rows, windows, n_keys) -> dict:
    """A canonical CAP-row stash (random rows folded in by the
    reference's ring fold) as numpy."""
    st, _, _ = ref_cascade.tier_ring_fold(
        ref_stash.stash_init(CAP, REF_TAGS, REF_METER),
        _jnp_state(ref_stash.AccumState, _rand_rows(rng, RING, rows, windows, n_keys)),
        jnp.zeros((2,), jnp.uint32), sum_cols_t=SUM_COLS, max_cols_t=MAX_COLS,
        shared_sort=True)
    return _np_state(st)


def _child_flush(rng, rows, lo, hi, n_keys=1500):
    """A tier-0 advance's packed flush matrix [CHILD, 3+T+M] (numpy u32)
    and row count: a child stash of `rows` random rows over windows
    lo … hi+1 (the last two stay open), flushed over [lo, hi)."""
    child = _jnp_state(ref_stash.StashState, _canonical(rng, rows, (lo, hi + 2), n_keys))
    _, packed, total = ref_stash.stash_flush_range(child, np.uint32(lo), np.uint32(hi))
    return np.asarray(packed), int(total)


def _port_packed(packed: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(packed, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# tier_step / tier_ring_fold / on_advance


# (fill, child rows, [lo, hi), prefix): the branch each geometry takes
BRANCHES = {
    "append": (PREFIX, 3000, (118, 119), PREFIX),
    "fold_append": (RING, 3000, (118, 120), PREFIX),
    "direct": (2 * PREFIX, 7000, (116, 122), PREFIX),
    "degenerate": (PREFIX, 3000, (118, 119), CHILD),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_tier_step_bit_equal(branch):
    """Each branch of the reference's `lax.cond` against the port's
    masked step: every tier-stash lane (dead tail included, sheds past
    the full tier), the ring (slot lane, and every lane of its live
    rows), fill and both lanes."""
    fill, rows, (lo, hi), prefix = BRANCHES[branch]
    rng = np.random.default_rng(7 + len(branch))
    packed, total = _child_flush(rng, rows, lo, hi)
    assert (total > PREFIX) == (branch == "direct") and total > 0
    tier = _canonical(rng, 8000, (1, 3), 2500)
    ring = _rand_rows(rng, RING, fill, (1, 3), 2500)
    lanes = np.array([7, 3], np.uint32)
    r_tier, r_ring, r_fill, r_lanes = ref_cascade.tier_step(
        _jnp_state(ref_stash.StashState, tier), _jnp_state(ref_stash.AccumState, ring),
        jnp.int32(fill), jnp.asarray(lanes), jnp.asarray(packed), jnp.int32(total),
        np.uint32(hi), ratio=60, num_tags=NT, sum_cols_t=SUM_COLS, max_cols_t=MAX_COLS,
        prefix=prefix, shared_sort=True)
    p_tier, p_ring, p_fill, p_lanes = cascade.tier_step(
        convert.stash_from_numpy(tier, "cpu"), convert.accum_from_numpy(ring, "cpu"),
        torch.tensor(fill), from_numpy_u32(lanes, "cpu"), _port_packed(packed),
        torch.tensor(total), hi, ratio=60, meter_schema=METER, num_tags=NT, prefix=prefix)
    _assert_lanes_equal(_np_state(r_tier), convert.stash_to_numpy(p_tier), branch)
    r_ring = _np_state(r_ring)
    _assert_ring_equal(r_ring, convert.accum_to_numpy(p_ring), branch)
    if branch in ("append", "fold_append"):  # the appended rows are live
        assert (r_ring["slot"] != SENT).sum() > 0
    assert int(r_fill) == int(p_fill)
    np.testing.assert_array_equal(np.asarray(r_lanes), p_lanes.numpy())
    if branch in ("direct", "degenerate", "fold_append"):
        assert int(r_lanes[1]) > 3  # the merge shed rows past the tier's capacity


def test_tier_ring_fold_bit_equal():
    rng = np.random.default_rng(21)
    tier = _canonical(rng, 7000, (1, 3), 2500)
    ring = _rand_rows(rng, RING, 3 * PREFIX, (1, 3), 2500)
    lanes = np.array([5, 0], np.uint32)
    r_tier, r_ring, r_lanes = ref_cascade.tier_ring_fold(
        _jnp_state(ref_stash.StashState, tier), _jnp_state(ref_stash.AccumState, ring),
        jnp.asarray(lanes), sum_cols_t=SUM_COLS, max_cols_t=MAX_COLS, shared_sort=True)
    p_tier, p_ring, p_lanes = cascade.tier_ring_fold(
        convert.stash_from_numpy(tier, "cpu"), convert.accum_from_numpy(ring, "cpu"),
        from_numpy_u32(lanes, "cpu"), METER)
    _assert_lanes_equal(_np_state(r_tier), convert.stash_to_numpy(p_tier), "ring fold")
    _assert_ring_equal(_np_state(r_ring), convert.accum_to_numpy(p_ring), "ring fold")
    np.testing.assert_array_equal(np.asarray(r_lanes), p_lanes.numpy())
    assert int(p_lanes[1]) > 0


def _ref_cascade_np(c) -> dict:
    return {"tiers": [_np_state(t) for t in c.tiers],
            "accs": [None if a is None else _np_state(a) for a in c.accs],
            "fills": [np.asarray(f) for f in c.fills], "lanes": np.asarray(c.lanes_dev),
            "watermarks": list(c.watermarks)}


def _assert_cascade_equal(ref_c, port_c, msg):
    want, got = _ref_cascade_np(ref_c), convert.cascade_to_numpy(port_c)
    assert want["watermarks"] == got["watermarks"], msg
    assert [int(f) for f in want["fills"]] == [int(f) for f in got["fills"]], msg
    np.testing.assert_array_equal(want["lanes"], got["lanes"], err_msg=msg)
    for i, (a, b) in enumerate(zip(want["tiers"], got["tiers"])):
        _assert_lanes_equal(a, b, f"{msg} tier {i}")
    for i, (a, b) in enumerate(zip(want["accs"], got["accs"])):
        assert (a is None) == (b is None), msg
        if a is not None:
            _assert_ring_equal(a, b, f"{msg} ring {i}")


def test_on_advance_two_tier_chain_bit_equal():
    """A minute + hour cascade over a run of advances: a first one that
    closes the empty windows before the data, five 1-window appends (the
    fourth finds the ring full: fold+append), a minute close that also
    closes an hour, a multi-window jump past the prefix (direct fold),
    and the shutdown drain (hi = U32_MAX). After each advance the
    TierFlush list (tier, interval, range, rows) and the whole tier state
    equal the reference's; the state also crosses through `convert`, and
    `settle_rings` (the checkpoint's fold of every ring) matches the
    reference's on a ring that holds rows."""
    cfg = dict(intervals=(60, 3600), capacity=CAP)
    ref = ref_cascade.TierCascade(ref_cascade.CascadeConfig(**cfg), 1, REF_TAGS, REF_METER)
    port = cascade.TierCascade(CascadeConfig(**cfg), 1, TAGS, METER, device="cpu")
    rng = np.random.default_rng(5)
    # (lo, hi, child rows, keys): the last two minute-120 advances hold
    # more keys than the minute stash
    advances = [(7178, 7181, 2000, 1500)] + [(w, w + 1, 2000, 1500) for w in range(7181, 7186)] + [
        (7186, 7201, 2000, 1500), (7201, 7214, 4000, 20000), (7214, 0xFFFFFFFF, 4000, 20000)]
    closed = {0: 0, 1: 0}
    for step, (lo, hi, rows, keys) in enumerate(advances):
        top = min(hi, lo + 10)
        packed, total = _child_flush(rng, rows, lo, top, keys)
        r_out = ref.on_advance(jnp.asarray(packed), jnp.int32(total), hi)
        p_out = port.on_advance(_port_packed(packed), torch.tensor(total), hi)
        assert [(f.tier, f.interval, f.lo, f.hi) for f in r_out] == \
            [(f.tier, f.interval, f.lo, f.hi) for f in p_out], step
        for a, b in zip(r_out, p_out):
            n = int(a.total)
            assert n == int(b.total), step
            np.testing.assert_array_equal(np.asarray(a.packed)[:n].view(np.int32),
                                          b.packed[:n].numpy(), err_msg=f"step {step}")
            closed[a.tier] += n
        _assert_cascade_equal(ref, port, f"step {step}")
        if step == 4:  # carry the reference's state into a fresh port cascade
            port = convert.cascade_from_numpy(
                cascade.TierCascade(CascadeConfig(**cfg), 1, TAGS, METER, device="cpu"),
                _ref_cascade_np(ref))
        if step == 5:  # the fold+append left a prefix of rows in the minute ring
            assert int(port.fills[0]) > 0
            ref.settle_rings()
            port.settle_rings()
            _assert_cascade_equal(ref, port, "settle_rings")
            assert [int(f) for f in port.fills] == [0, 0]
    assert closed[0] > 0 and closed[1] > 0
    assert int(port.lanes_dev[0]) > 0 and int(port.lanes_dev[1]) > 0  # rows and sheds


# ---------------------------------------------------------------------------
# pipelines


def _record_blocks(wm) -> list:
    blocks, process = [], wm._process_block

    def record(vec):
        blocks.append([int(v) for v in vec])
        process(vec)

    wm._process_block = record
    return blocks


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def _assert_docs_equal(ref_docs, port_docs):
    assert len(ref_docs) == len(port_docs) > 0
    for a, b in zip(ref_docs, port_docs):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))


def _pipes(cls_name, capacity, intervals, tier_capacity, batch, sketch=None,
           fold_mode="full"):
    """(reference, port) pipelines of one cascade configuration;
    `sketch` is a (reference, port) SketchConfig pair."""
    ref_cls, cls = getattr(ref_pipeline, cls_name), getattr(pipeline, cls_name)
    r_sk, p_sk = sketch or (None, None)
    ref = ref_cls(ref_pipeline.PipelineConfig(
        window=ref_window.WindowConfig(
            capacity=capacity, sketch=r_sk, fold_mode=fold_mode,
            cascade=ref_cascade.CascadeConfig(intervals=intervals, capacity=tier_capacity)),
        batch_size=batch))
    port = cls(pipeline.PipelineConfig(
        window=WindowConfig(capacity=capacity, sketch=p_sk, fold_mode=fold_mode,
                            cascade=CascadeConfig(intervals=intervals,
                                                  capacity=tier_capacity)),
        batch_size=batch), device="cpu")
    return ref, port


def _batches(spans, n, tuples, seed, app=False):
    if app:
        gen = SyntheticAppGen(num_services=16, endpoints_per_service=4, seed=seed)
        return [gen.app_batch(n, t) for t in spans]
    gen = RefFlowGen(num_tuples=tuples, seed=seed)
    return [RefFlowBatch.from_records(gen.records(n, t)) for t in spans]


def _run(ref, port, batches):
    """Both pipelines over the batches and a drain: (ref 1 s docs, port
    1 s docs, ref tier pairs, port tier pairs, ref blocks, port blocks)."""
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    r_docs, p_docs, r_tiers, p_tiers = [], [], [], []
    for fb in batches:
        r_docs += ref.ingest(fb)
        p_docs += port.ingest(_port_batch(fb))
        r_tiers += ref.pop_tier_docbatches()
        p_tiers += port.pop_tier_docbatches()
    r_docs += ref.drain()
    p_docs += port.drain()
    r_tiers += ref.pop_tier_docbatches()
    p_tiers += port.pop_tier_docbatches()
    return r_docs, p_docs, r_tiers, p_tiers, r_blocks, p_blocks


def _assert_tiers_equal(r_tiers, p_tiers):
    assert [iv for iv, _ in r_tiers] == [iv for iv, _ in p_tiers]
    _assert_docs_equal([db for _, db in r_tiers], [db for _, db in p_tiers])


COUNTER_KEYS = ("doc_in", "flushed_doc", "drop_before_window", "cascade_rows",
                "cascade_shed", "tier_windows_held", "tier_windows_dropped",
                "cascade_tiers", "cascade_tier_windows", "cascade_pending_blocks")


def _assert_counters_equal(ref, port):
    r_c, p_c = ref.get_counters(), port.get_counters()
    for key in COUNTER_KEYS:
        assert r_c[key] == p_c[key], key


# the late-row minute-boundary stream of
# test_cascade_minute_bit_exact_vs_double_ingest: T0+19 / T0+21 straddle
# the boundary at T0+20, and the second T0+19 batch arrives after it
MINUTE_SPANS = [T0, T0 + 19, T0 + 21, T0 + 19, T0 + 30, T0 + 90]


@pytest.mark.parametrize("cls_name", ["L4Pipeline", "L7Pipeline"])
def test_pipeline_minute_boundary_bit_equal(cls_name):
    """1 s docs, tier docs and every counter block equal to the
    reference's; the minute's rows merge across seconds."""
    app = cls_name == "L7Pipeline"
    ref, port = _pipes(cls_name, CAP, (60,), CAP, 256)
    r_docs, p_docs, r_tiers, p_tiers, r_blocks, p_blocks = _run(
        ref, port, _batches(MINUTE_SPANS, 100, 50, 3, app=app))
    _assert_docs_equal(r_docs, p_docs)
    _assert_tiers_equal(r_tiers, p_tiers)
    assert r_blocks == p_blocks
    assert r_blocks[-1][window.CB_CASCADE_ROWS] > 0
    _assert_counters_equal(ref, port)
    assert {iv for iv, _ in p_tiers} == {60} and len(p_tiers) >= 2
    assert 0 < sum(db.size for _, db in p_tiers) < sum(db.size for db in p_docs)


@pytest.mark.parametrize("case", ["hour", "overflow"])
def test_hour_tier_and_tier_overflow_bit_equal(case):
    """The hour tier folds minutes (its packet total equals theirs), and
    minute of about 8,000 rows sheds from the 4096-row minute stash —
    `cascade_shed` > 0 and equal to the reference's."""
    if case == "hour":
        ref, port = _pipes("L4Pipeline", CAP, (60, 3600), CAP, 256)
        batches = _batches([T0, T0 + 30, T0 + 90, T0 + 3700, T0 + 7300], 100, 40, 13)
    else:
        ref, port = _pipes("L4Pipeline", CAP, (60,), CAP, 256)
        batches = _batches([T0 + i for i in range(10)] + [T0 + 90, T0 + 91], 256, 3000, 17)
    r_docs, p_docs, r_tiers, p_tiers, r_blocks, p_blocks = _run(ref, port, batches)
    _assert_docs_equal(r_docs, p_docs)
    _assert_tiers_equal(r_tiers, p_tiers)
    assert r_blocks == p_blocks
    _assert_counters_equal(ref, port)
    c = port.get_counters()
    if case == "hour":
        pkt = schema.FLOW_METER.index("packet_tx")
        minutes = sum(db.meters[:, pkt].sum() for iv, db in p_tiers if iv == 60)
        hours = sum(db.meters[:, pkt].sum() for iv, db in p_tiers if iv == 3600)
        assert minutes == hours > 0
        assert c["cascade_rows"] > sum(db.size for db in p_docs) and c["cascade_shed"] == 0
    else:
        assert c["cascade_shed"] > 0
        assert sum(db.size for _, db in p_tiers) <= CAP * 2


def _assert_blocks_equal(a, b):
    assert (a.window, a.n_updates) == (b.window, b.n_updates)
    for lane in ("hll", "cms", "hist", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb"):
        np.testing.assert_array_equal(getattr(a, lane), getattr(b, lane),
                                      err_msg=(a.window, lane))


@pytest.mark.parametrize("mode", ["slab_full", "pool_merge"])
def test_tier_sketch_blocks_bit_equal(mode):
    """`closed_tier_sketches` lane for lane (top-K candidate order
    included), and each equals the merge of its 1 s blocks."""
    pool = mode == "pool_merge"
    sketch = (_sk(RefSketchConfig, RefLogHistSpec, RefPoolConfig() if pool else None),
              _sk(SketchConfig, LogHistSpec, PoolConfig() if pool else None))
    ref, port = _pipes("L4Pipeline", CAP, (60,), CAP, 256, sketch=sketch,
                       fold_mode="merge" if pool else "full")
    spans = [T0, T0 + 3, T0 + 8, T0 + 14, T0 + 19, T0 + 21, T0 + 90]
    r_docs, p_docs, r_tiers, p_tiers, r_blocks, p_blocks = _run(
        ref, port, _batches(spans, 128, 80, 11))
    _assert_docs_equal(r_docs, p_docs)
    _assert_tiers_equal(r_tiers, p_tiers)
    strip = lambda bl: [b[:window.CB_SKETCH_POOL_SPILL] for b in bl]  # noqa: E731
    assert strip(r_blocks) == strip(p_blocks)  # lanes 18–20: see test_torch_sketch_pool
    r_tb, p_tb = ref.closed_tier_sketches, port.closed_tier_sketches
    assert len(r_tb) == len(p_tb) >= 2
    for a, b in zip(r_tb, p_tb):
        _assert_blocks_equal(a, b)
    children = port.pop_closed_sketches()
    for blk in p_tb:
        kids = sorted((c for c in children if c.window // 60 == blk.window),
                      key=lambda c: c.window)
        want = dataclasses.replace(kids[0], window=blk.window)
        for c in kids[1:]:
            want = want.merge(dataclasses.replace(c, window=blk.window))
        _assert_blocks_equal(want, blk)


def _empty_block(mod_block, cfg, window):
    g, m = cfg.num_groups, cfg.hll_m
    return mod_block(
        window=window, config=cfg, n_updates=7, hll=np.zeros((g, m), np.int32),
        cms=np.zeros((cfg.cms_depth, cfg.cms_width), np.int64),
        hist=np.zeros((g, cfg.hist.bins), np.int64), tk_hi=np.zeros((0,), np.uint32),
        tk_lo=np.zeros((0,), np.uint32), tk_ida=np.zeros((0,), np.uint32),
        tk_idb=np.zeros((0,), np.uint32), tk_votes=np.zeros((0,), np.int64))


def test_sketch_only_tier_window_after_empty_drain():
    """A minute whose children were all sketch-only closes at a drain
    that transfers nothing: one count-0 tier window carrying the merged
    block, nothing left pending — as in the reference."""
    from deepflow_tpu.aggregator.sketchplane import WindowSketchBlock as RefBlock
    from deepflow_tpu_torch.aggregator.sketchplane import WindowSketchBlock

    out = {}
    for side in ("ref", "port"):
        mod_w, sk = ((ref_window, _sk(RefSketchConfig, RefLogHistSpec)) if side == "ref"
                     else (window, _sk(SketchConfig, LogHistSpec)))
        casc = (ref_cascade.CascadeConfig if side == "ref" else CascadeConfig)(
            intervals=(60,), capacity=CAP)
        kw = {} if side == "ref" else {"device": "cpu"}
        # the shapes of the slab sketch pipeline test: its compiles serve here
        wm = mod_w.WindowManager(mod_w.WindowConfig(capacity=CAP, sketch=sk,
                                                    cascade=casc), **kw)
        wm.cascade.feed_block(0, 59, _empty_block(RefBlock if side == "ref"
                                                  else WindowSketchBlock, sk, 59))
        if side == "ref":
            wm.state, packed, total = ref_stash.stash_flush_range(
                wm.state, np.uint32(0), np.uint32(100))
        else:
            wm.state, packed, total = stash._flush_range_impl(wm.state, 0, 100)
        entry = wm._make_flush_entry(packed, total, 0, 100)
        assert entry.tiers
        assert wm._drain_flush(entry) == []
        out[side] = (wm.pop_tier_windows(), wm.cascade.pending_blocks[0], wm.host_fetches)
    (r_t, r_pend, r_f), (p_t, p_pend, p_f) = out["ref"], out["port"]
    assert [(f.window_idx, f.count, f.tier, f.interval, f.sketches.n_updates) for f in p_t] \
        == [(f.window_idx, f.count, f.tier, f.interval, f.sketches.n_updates) for f in r_t] \
        == [(0, 0, 1, 60, 7)]
    assert not p_pend and not r_pend and p_f == r_f


# ---------------------------------------------------------------------------
# dual-granularity shims


def _shim_stream(pipe, batches, port: bool):
    out = []
    for fb in batches:
        out += pipe.ingest(_port_batch(fb) if port else fb)
    return out + pipe.drain()


def _assert_flagged_equal(ref_out, port_out):
    assert [int(f) for f, _ in ref_out] == [int(f) for f, _ in port_out]
    _assert_docs_equal([db for _, db in ref_out], [db for _, db in port_out])


@pytest.mark.parametrize("shim", ["dual", "double"])
def test_dual_granularity_stream_bit_equal(shim):
    """The (flags, DocBatch) stream and every counter block of each shim
    equal the reference's: PER_SECOND for 1 s, NONE for 1 m; the dual
    shim's hours go to `coarse_tiers`, and the dual minutes equal the
    double-ingest's."""
    if shim == "dual":
        intervals = (60, 3600)
        spans = [T0, T0 + 19, T0 + 21, T0 + 19, T0 + 90, T0 + 3700]
        ref = ref_pipeline.DualGranularityPipeline(ref_pipeline.PipelineConfig(
            window=ref_window.WindowConfig(capacity=CAP, cascade=ref_cascade.CascadeConfig(
                intervals=intervals, capacity=CAP)), batch_size=256))
        port = pipeline.DualGranularityPipeline(pipeline.PipelineConfig(
            window=WindowConfig(capacity=CAP, cascade=CascadeConfig(
                intervals=intervals, capacity=CAP)), batch_size=256), device="cpu")
    else:
        spans = MINUTE_SPANS
        ref = ref_pipeline.DoubleIngestPipeline(ref_pipeline.PipelineConfig(
            window=ref_window.WindowConfig(capacity=CAP), batch_size=256))
        port = pipeline.DoubleIngestPipeline(pipeline.PipelineConfig(
            window=WindowConfig(capacity=CAP), batch_size=256), device="cpu")
    batches = _batches(spans, 100, 50, 3)
    pipes = ((ref.pipe, port.pipe) if shim == "dual"
             else ((ref.second, port.second), (ref.minute, port.minute)))
    blocks = [(_record_blocks(r.wm), _record_blocks(p.wm))
              for r, p in (pipes if shim == "double" else (pipes,))]
    r_out, p_out = _shim_stream(ref, batches, False), _shim_stream(port, batches, True)
    _assert_flagged_equal(r_out, p_out)
    for r_blocks, p_blocks in blocks:
        assert r_blocks == p_blocks and r_blocks
    flags = {f for f, _ in p_out}
    assert flags == {DocumentFlag.PER_SECOND_METRICS, DocumentFlag.NONE}
    if shim == "dual":
        assert [iv for iv, _ in port.coarse_tiers] == [iv for iv, _ in ref.coarse_tiers]
        assert port.coarse_tiers and all(iv == 3600 for iv, _ in port.coarse_tiers)
        _assert_docs_equal([db for _, db in ref.coarse_tiers],
                           [db for _, db in port.coarse_tiers])
        assert port.second is port.pipe
        r_m, p_m = ref.counters["minute"], port.counters["minute"]
        assert r_m == p_m and p_m["cascade_rows"] > 0
        with pytest.raises(ValueError, match="conflicting"):
            pipeline.DualGranularityPipeline(
                port.pipe.config, cascade=CascadeConfig(intervals=(60,), capacity=1 << 10),
                device="cpu")
        with pytest.raises(ValueError, match="1m cascade tier"):
            pipeline.DualGranularityPipeline(pipeline.PipelineConfig(window=WindowConfig(
                cascade=CascadeConfig(intervals=(3600,)))), device="cpu")
    else:
        # the cascade's minutes equal the oracle's on the same stream
        dual = pipeline.DualGranularityPipeline(pipeline.PipelineConfig(
            window=WindowConfig(capacity=CAP), batch_size=256), device="cpu")
        d_out = _shim_stream(dual, batches, True)
        canon = lambda out: sorted(  # noqa: E731
            (int(db.timestamp[i]),) + tuple(db.tags[i].tolist())
            + tuple(db.meters[i].view(np.uint32).tolist())
            for f, db in out if f == DocumentFlag.NONE for i in range(db.size))
        assert canon(d_out) == canon(p_out) and canon(p_out)
        assert port.counters["minute"]["flushed_doc"] > 0


def test_cascade_host_fetch_budget(monkeypatch):
    """≤ 3 host_fetch calls per ingest with the cascade on, the ingest
    that closes a minute and an hour included; the tier step reads
    nothing back (no fetch outside the seam: the CPU run could not tell,
    so the card run counts copies in a trace)."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    pipe = pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=WindowConfig(capacity=CAP,
                            cascade=CascadeConfig(intervals=(60, 3600), capacity=CAP)),
        batch_size=256), device="cpu")
    gen = RefFlowGen(num_tuples=200, seed=3)
    per_ingest = []
    for t in (T0, T0 + 1, T0 + 4, T0 + 25, T0 + 26, T0 + 3700, T0 + 3701):
        before = counts["n"]
        pipe.ingest(_port_batch(RefFlowBatch.from_records(gen.records(256, t))))
        per_ingest.append(counts["n"] - before)
    assert max(per_ingest) <= SYNC_BUDGET
    tiers = pipe.pop_tier_docbatches()
    assert {iv for iv, _ in tiers} == {60, 3600}


@pytest.mark.parametrize("case", [
    "empty", "descending", "capacity", "not_multiple", "equal_base", "type", "meta"])
def test_cascade_config_validation(case):
    """The port's CascadeConfig rejects what the reference's rejects,
    with the same message; WindowConfig takes only the port's class."""
    def build(casc_cls, win_cls):
        if case == "empty":
            return casc_cls(intervals=())
        if case == "descending":
            return casc_cls(intervals=(3600, 60))
        if case == "capacity":
            return casc_cls(capacity=0)
        if case == "not_multiple":
            return casc_cls(intervals=(60, 90)).validate_base(1)
        if case == "equal_base":
            return win_cls(interval=60, cascade=casc_cls(intervals=(60,)))
        return casc_cls(intervals=(60, 3600), capacity=512)

    if case == "type":
        with pytest.raises(TypeError, match="CascadeConfig"):
            WindowConfig(cascade=ref_cascade.CascadeConfig())
        with pytest.raises(TypeError, match="CascadeConfig"):
            WindowConfig(cascade=object())
        return
    if case == "meta":
        r, p = build(ref_cascade.CascadeConfig, None), build(CascadeConfig, None)
        assert p.meta() == r.meta() and CascadeConfig.from_meta(r.meta()) == p
        assert WindowConfig(cascade=p).cascade is p
        return
    with pytest.raises(ValueError) as r_err:
        build(ref_cascade.CascadeConfig, ref_window.WindowConfig)
    with pytest.raises(ValueError) as p_err:
        build(CascadeConfig, WindowConfig)
    assert str(p_err.value) == str(r_err.value)


def test_pending_block_arrays_roundtrip():
    """Open parents' partially merged blocks cross a checkpoint in the
    reference's array layout: the port's arrays equal the reference's
    for the same blocks, and restore gives the blocks back."""
    from deepflow_tpu.aggregator.sketchplane import WindowSketchBlock as RefBlock
    from deepflow_tpu_torch.aggregator.sketchplane import WindowSketchBlock

    r_cfg, p_cfg = _sk(RefSketchConfig, RefLogHistSpec), _sk(SketchConfig, LogHistSpec)

    def blk(mod, cfg, w, seed):
        r = np.random.default_rng(seed)
        b = _empty_block(mod, cfg, w)
        return dataclasses.replace(
            b, n_updates=int(r.integers(1, 99)),
            hll=r.integers(0, 9, b.hll.shape).astype(np.int32),
            cms=r.integers(0, 99, b.cms.shape).astype(np.int64),
            tk_hi=r.integers(0, 2**32, 5, dtype=np.uint64).astype(np.uint32),
            tk_lo=np.arange(5, dtype=np.uint32), tk_ida=np.arange(5, dtype=np.uint32),
            tk_idb=np.arange(5, dtype=np.uint32), tk_votes=np.arange(1, 6, dtype=np.int64))

    seeds = {(0, 119): 1, (0, 120): 2, (1, 2): 3}
    r_pend, p_pend = [{}, {}], [{}, {}]
    for (tier, w), s in seeds.items():
        ref_cascade.merge_into_parent(r_pend[tier], w * 60, 60, blk(RefBlock, r_cfg, w * 60, s))
        cascade.merge_into_parent(p_pend[tier], w * 60, 60,
                                  blk(WindowSketchBlock, p_cfg, w * 60, s))
    r_meta, r_arr = ref_cascade.pending_block_arrays(r_pend)
    p_meta, p_arr = cascade.pending_block_arrays(p_pend)
    assert p_meta == r_meta and set(p_arr) == set(r_arr)
    for k in r_arr:
        np.testing.assert_array_equal(r_arr[k], p_arr[k], err_msg=k)
        assert r_arr[k].dtype == p_arr[k].dtype, k
    back = [{}, {}]
    cascade.restore_pending_blocks(back, r_meta, r_arr, p_cfg)
    for tier in (0, 1):
        assert sorted(back[tier]) == sorted(p_pend[tier])
        for w, b in back[tier].items():
            _assert_blocks_equal(p_pend[tier][w], b)
