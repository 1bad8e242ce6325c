"""Port parity for pooled sketch memory (`SketchConfig(pool=PoolConfig)`).

The same seeded numpy streams go through the JAX package (CPU backend)
and the port on the CPU, at the POOL geometry of
tests/test_sketch_pool.py, and must come out bit-equal:

  * the pool ops: `cms_expand`, `loghist_coarsen_bin` / `loghist_expand`
    (device and numpy forms), `topk_tile` / `topk_merge`, the int8
    register packing, and the geometry `_check_pool` rejects;
  * every field of the plane after each `sketch_plane_step` — compact
    seating, promotion, exhaustion spill, compact and wide closes — and
    the pending rows and wide rows of the drain;
  * `from_compact_row` / `unpack_drained`, and WindowManager's flushed
    windows, sketch blocks and counter blocks (lanes 18–20 included);
  * the slice as a whole: L4Pipeline and make_ingest_step with the
    pooled plane AND the merge fold, within 3 fetches per ingest.

The only tolerance is the t-digest's rtol 1e-5 on quantile floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import sketchplane as ref_sp
from deepflow_tpu.aggregator import stash as ref_stash
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.aggregator.fanout import FANOUT_LANES
from deepflow_tpu.aggregator.fanout import FanoutConfig as RefFanoutConfig
from deepflow_tpu.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu.ops import cms as ref_cms
from deepflow_tpu.ops import histogram as ref_hist
from deepflow_tpu.ops import hll as ref_hll
from deepflow_tpu.ops import topk as ref_topk
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import pipeline, sketchplane, stash, window
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
from deepflow_tpu_torch.ops import cms, histogram, hll, topk
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32
from tests.test_torch_sketch_plane import (
    _assert_blocks_equal,
    _assert_docs_equal,
    _assert_flushed_equal,
    _assert_plane_equal,
    _assert_stash_equal,
    _doc_batch,
    _flow_batches,
    _np_state,
    _port_batch,
    _record_blocks,
)

torch.set_num_threads(1)

T0 = 1_700_000_000
SYNC_BUDGET = 3  # tests/test_perf_gate.py

# the geometry of tests/test_sketch_pool.py
_SK = dict(num_groups=4, hll_precision=8, cms_depth=3, cms_width=512, topk_rows=2,
           topk_cols=128, pending=10)
_HIST = dict(bins=64, vmin=1.0, gamma=1.2)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)


def _configs(pool=None, **over):
    """(reference SketchConfig, port SketchConfig), pooled with `pool`
    overrides of the POOL geometry."""
    kw = {**_SK, **over}
    pool = {**_POOL, **(pool or {})}
    return (ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), pool=ref_sp.PoolConfig(**pool),
                                **kw),
            sketchplane.SketchConfig(hist=LogHistSpec(**_HIST),
                                     pool=sketchplane.PoolConfig(**pool), **kw))


def _u32(x):
    return from_numpy_u32(x, "cpu")


# ---------------------------------------------------------------------------
# pool ops


def test_pool_lane_ops_bit_equal():
    rng = np.random.default_rng(1)
    compact = rng.integers(-50, 5000, (3, 64)).astype(np.int32)
    want = np.asarray(ref_cms.cms_expand(jnp.asarray(compact), 512))
    np.testing.assert_array_equal(want, cms.cms_expand(torch.from_numpy(compact), 512).numpy())
    np.testing.assert_array_equal(want, cms.cms_expand(compact, 512, xp=np))

    bins = rng.integers(0, 64, 300).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(ref_hist.loghist_coarsen_bin(jnp.asarray(bins), 8)),
                                  histogram.loghist_coarsen_bin(torch.from_numpy(bins), 8))
    h = rng.integers(0, 90, (4, 8)).astype(np.int32)
    want = np.asarray(ref_hist.loghist_expand(jnp.asarray(h), 64))
    np.testing.assert_array_equal(want, histogram.loghist_expand(torch.from_numpy(h), 64))
    np.testing.assert_array_equal(ref_hist.loghist_expand(h.astype(np.int64), 64, xp=np),
                                  histogram.loghist_expand(h.astype(np.int64), 64, xp=np))

    regs = rng.integers(0, 34, (2, 4, 256)).astype(np.int8)
    want = np.asarray(ref_hll.hll_pack_registers(jnp.asarray(regs)))
    got = hll.hll_pack_registers(torch.from_numpy(regs))
    np.testing.assert_array_equal(want, got.numpy().astype(np.uint32))
    np.testing.assert_array_equal(want, hll.hll_pack_registers(regs))


def _lanes(rng, shape, keys=6):
    """(votes, hi, lo, ia, ib): votes int32 (some ≤ 0), u32 lanes from a
    few keys so buckets share them."""
    k = rng.integers(0, keys, shape).astype(np.uint32)
    u32 = lambda: rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return (rng.integers(-5, 60, shape).astype(np.int32), k * np.uint32(2654435761), k, u32(),
            u32())


def _port_lanes(lanes):
    return (torch.from_numpy(lanes[0]),) + tuple(
        torch.from_numpy(x.view(np.int32)) for x in lanes[1:])


def test_topk_tile_and_merge_bit_equal():
    rng = np.random.default_rng(2)
    a, b = _lanes(rng, (2, 32)), _lanes(rng, (2, 32))
    for want, got in zip(ref_topk.topk_tile(tuple(map(jnp.asarray, a)), 128),
                         topk.topk_tile(_port_lanes(a), 128)):
        np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy())
    want = ref_topk.topk_merge(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    for w, g in zip(want, topk.topk_merge(_port_lanes(a), _port_lanes(b))):
        np.testing.assert_array_equal(np.asarray(w).view(np.int32), g.numpy())


@pytest.mark.parametrize("bad,match", [
    (dict(pool=dict(wide_slots=0)), "wide_slots"),
    (dict(pool=dict(compact_slots=0)), "compact_slots"),
    (dict(pool=dict(cms_factor=3)), "power of two"),
    (dict(pool=dict(cms_factor=1024)), "cannot promote the cms lane"),
    (dict(pool=dict(hist_factor=128)), "cannot promote the hist lane"),
    (dict(pool=dict(topk_factor=256)), "cannot promote the topk lane"),
    (dict(pool=dict(promote_fill=0.0)), "promote_fill"),
    (dict(pool=dict(promote_fill=1.5)), "promote_fill"),
    (dict(hll_precision=1), "divisible by 4"),
    (dict(cms_depth=0), "cms_depth"),
])
def test_pool_geometry_rejected(bad, match):
    """The port rejects every geometry the reference rejects, with the
    same lane named."""
    kw = {**_SK, **{k: v for k, v in bad.items() if k != "pool"}}
    pool = {**_POOL, **bad.get("pool", {})}
    for mod, spec in ((ref_sp, RefLogHistSpec), (sketchplane, LogHistSpec)):
        with pytest.raises(ValueError, match=match):
            mod.SketchConfig(hist=spec(**_HIST), pool=mod.PoolConfig(**pool), **kw)


def test_pool_meta_roundtrip():
    ref_cfg, cfg = _configs()
    assert cfg.meta() == ref_cfg.meta()
    assert sketchplane.SketchConfig.from_meta(ref_cfg.meta()) == cfg
    assert cfg.compact_block_width == ref_cfg.compact_block_width < cfg.block_width
    slab = dataclasses.replace(cfg, pool=None)
    assert sketchplane.SketchConfig.from_meta({**slab.meta(), "pool": None}) == slab


# ---------------------------------------------------------------------------
# the plane, step by step


def _plane_batch(rng, n, windows, keys):
    u32 = lambda size: rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    kid = rng.integers(0, keys, n)
    rtt = rng.uniform(0.5, 3000, n).astype(np.float32)
    rtt[:2] = [np.nan, 0.0]
    weight = rng.integers(0, 600, n).astype(np.float32)
    weight[rng.random(n) < 0.03] = 5e9
    return dict(
        window=np.asarray(windows, np.uint32), valid=rng.random(n) > 0.1,
        group=rng.integers(0, 4, n).astype(np.uint32), client_hi=u32(n), client_lo=u32(n),
        key_hi=(kid * 2654435761 + 1).astype(np.uint32),
        key_lo=(kid ^ 0x9E3779B9).astype(np.uint32), weight=weight, rtt=rtt,
        rtt_valid=rng.random(n) > 0.2, id_a=kid.astype(np.uint32), id_b=u32(n),
    )


def _pool_stream(seed):
    """(inputs, base_w, close_w) batches: a wide key set that saturates
    compact count-min rows (promotion), a narrow one that does not, four
    windows open at once (more than the compact slots), closes of
    compact and wide slots, and a jump that closes everything."""
    rng = np.random.default_rng(seed)
    out, sw = [], 0
    for lo_hi, keys in [((10, 10), 400), ((10, 11), 20), ((11, 13), 20), ((12, 13), 400),
                        ((13, 16), 30), ((15, 16), 400), ((40, 41), 20), ((41, 43), 400)]:
        win = rng.integers(lo_hi[0], lo_hi[1] + 1, 192)
        x = _plane_batch(rng, 192, win, keys)
        v = win[x["valid"]]
        close_w = max(sw, int(v.max()) - 2) if v.size else sw
        base_w = max(sw, min(int(v.min()), close_w)) if v.size else sw
        out.append((x, base_w, close_w))
        sw = close_w
    return out


# one compile per plane shape instead of an eager dispatch per op
_ref_step = jax.jit(ref_sp.sketch_plane_step, static_argnums=(1,))
U32_KEYS = ("window", "group", "client_hi", "client_lo", "key_hi", "key_lo", "id_a", "id_b")


@pytest.mark.parametrize("pool,topk_rows,drain_at", [
    (None, 2, (3, 6)), (dict(compact_slots=1, wide_slots=1), 2, ()), (None, 0, (4,))],
    ids=["promote", "spill", "no_topk"])
def test_plane_step_state_bit_equal(pool, topk_rows, drain_at):
    """Every plane field after each step and each drain; the stream must
    promote (or, with one compact slot, spill) for the test to bite."""
    ref_cfg, cfg = _configs(pool, topk_rows=topk_rows)
    r_sk = ref_sp.sketch_init(ref_cfg, 4)
    sk = sketchplane.sketch_init(cfg, 4, device="cpu")
    drained = 0
    for i, (x, base_w, close_w) in enumerate(_pool_stream(7 + topk_rows)):
        r_sk = _ref_step(r_sk, ref_cfg.hist, base_w=jnp.uint32(base_w),
                         close_w=jnp.uint32(close_w),
                         **{k: jnp.asarray(v) for k, v in x.items()})
        t = {k: (_u32(v) if k in U32_KEYS else torch.from_numpy(v)) for k, v in x.items()}
        sk = sketchplane.sketch_plane_step(sk, cfg.hist, base_w=base_w, close_w=close_w, **t)
        _assert_plane_equal(r_sk, sk)
        if i in drain_at or i == 7:
            hi = close_w if i < 7 else 2 ** 32 - 1
            r_sk, r_pend, r_pwin, r_n, r_wrows, r_wwins = ref_sp.sketch_drain(
                r_sk, jnp.uint32(hi))
            sk, pend, pwin, n, wrows, wwins = sketchplane.sketch_drain(sk, hi)
            assert int(r_n) == int(n)
            np.testing.assert_array_equal(np.asarray(r_pend)[:int(n)],
                                          pend[:int(n)].numpy().view(np.uint32))
            np.testing.assert_array_equal(np.asarray(r_pwin)[:int(n)], pwin[:int(n)].numpy())
            np.testing.assert_array_equal(np.asarray(r_wrows), wrows.numpy().view(np.uint32))
            np.testing.assert_array_equal(np.asarray(r_wwins), wwins.numpy())
            _assert_plane_equal(r_sk, sk)
            drained += int(n) + int((wwins != sketchplane.SENTINEL_WIN).sum())
    assert drained > 0 and int(sk.rows) > 0
    if pool is None:
        assert int(sk.pool_promos) > 0
    else:
        assert int(sk.pool_spill) > 0


def test_unpack_compact_rows_bit_equal():
    """Random compact and wide rows unpack to the reference's blocks."""
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(4)
    for width in (cfg.compact_block_width, cfg.block_width):
        rows = rng.integers(0, 2 ** 32, (3, width), dtype=np.uint64).astype(np.uint32)
        g, m = cfg.num_groups, cfg.hll_m
        if width == cfg.compact_block_width:  # registers 0..33 in each byte
            rows[:, 1:1 + g * m // 4] = hll.hll_pack_registers(
                rng.integers(0, 34, (3, g * m)).astype(np.int8))
        else:
            rows[:, 1:1 + g * m] %= 34
        wins = np.array([5, 6, 7], np.uint32)
        want = ref_sp.unpack_drained(rows, wins, ref_cfg)
        got = sketchplane.unpack_drained(rows, wins, cfg)
        assert len(want) == len(got) == 3
        for a, b in zip(want, got):
            _assert_blocks_equal(a, b, f"width {width}")


# ---------------------------------------------------------------------------
# WindowManager, L4Pipeline, make_ingest_step


def _run_managers(batches, ref_cfg, cfg, capacity=1 << 11, fold_mode="full"):
    kw = dict(capacity=capacity, delay=2, sketch=None, fold_mode=fold_mode)
    ref = ref_window.WindowManager(ref_window.WindowConfig(**{**kw, "sketch": ref_cfg}))
    port = window.WindowManager(window.WindowConfig(**{**kw, "sketch": cfg}), device="cpu")
    r_blocks, p_blocks = _record_blocks(ref), _record_blocks(port)
    r_out, p_out = [], []
    for keys, t in batches:
        n = len(keys)
        ts, hi, lo, tags, meters, valid = _doc_batch(keys, np.full(n, t), np.ones(n, bool),
                                                     np.full(n, 100.0))
        r_out += ref.ingest(ts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
                            jnp.asarray(meters), jnp.asarray(valid))
        p_out += port.ingest(*(_u32(x) for x in (ts, hi, lo, tags)),
                             torch.from_numpy(meters), torch.from_numpy(valid))
    r_out += ref.flush_all()
    p_out += port.flush_all()
    return ref, port, r_out, p_out, r_blocks, p_blocks


def _promote_stream(rng, n=512):
    """The reference's promoted-window stream, in batches of one size
    (one compile): one window saturates its compact slot, the next batch
    lands post-promotion in the wide slot with planted heavies, then a
    narrow window and a jump."""
    second = np.concatenate([rng.integers(0, 2000, n - 6 * 60).astype(np.uint32),
                             np.repeat(np.arange(6, dtype=np.uint32), 60)])
    return [(rng.integers(0, 2000, n).astype(np.uint32), T0), (second, T0),
            (np.arange(n, dtype=np.uint32) % 40, T0 + 1),
            (np.arange(n, dtype=np.uint32) % 8, T0 + 4)]


@pytest.mark.parametrize("case", ["promote", "spill"])
def test_window_manager_pool_bit_equal(case):
    """Flushed windows, sketch blocks and every counter block (pool
    lanes 18–20 included) equal the reference's; merge fold on."""
    rng = np.random.default_rng(61)
    if case == "promote":
        ref_cfg, cfg = _configs()
        batches = _promote_stream(rng)
    else:  # R = 4 ring slots, 2 pool slots
        ref_cfg, cfg = _configs(dict(compact_slots=1, wide_slots=1))
        ks = np.arange(30, dtype=np.uint32)
        batches = [(ks, T0 + i) for i in range(4)]
    ref, port, r_out, p_out, r_blocks, p_blocks = _run_managers(batches, ref_cfg, cfg,
                                                                fold_mode="merge")
    assert any(f.sketches is not None for f in p_out)
    _assert_flushed_equal(r_out, p_out, case)
    assert r_blocks == p_blocks
    lane = window.CB_SKETCH_PROMOTIONS if case == "promote" else window.CB_SKETCH_POOL_SPILL
    assert p_blocks[-1][lane] > 0 and max(b[window.CB_SKETCH_POOL_OCC] for b in p_blocks) > 0
    r_c, p_c = ref.get_counters(), port.get_counters()
    for key in ("sketch_rows", "sketch_shed", "sketch_pool_spill", "sketch_pool_occ",
                "sketch_promotions", "doc_in", "flushed_doc"):
        assert r_c[key] == p_c[key], key


def test_pipeline_pool_merge_bit_equal(monkeypatch):
    """The slice as a whole: L4Pipeline with the pooled plane and the
    merge fold over a multi-window stream with late rows — DocBatches,
    sketch blocks and counter blocks equal the reference's, ≤ 3 fetches
    per ingest."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    ref_cfg, cfg = _configs(dict(cms_factor=16))

    kw = dict(capacity=1 << 12, accum_batches=2, fold_mode="merge")
    ref = ref_pipeline.L4Pipeline(ref_pipeline.PipelineConfig(
        window=ref_window.WindowConfig(sketch=ref_cfg, **kw), batch_size=400,
        batch_unique_cap=256))
    port = pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=window.WindowConfig(sketch=cfg, **kw), batch_size=400,
        batch_unique_cap=256), device="cpu")
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    r_docs, p_docs, per_ingest = [], [], []
    for fb in _flow_batches([0, 0, 1, 2, 3, 1, 4, 7, 5, 8], 400, seed=8):
        r_docs += ref.ingest(fb)
        before = counts["n"]
        p_docs += port.ingest(_port_batch(fb))
        per_ingest.append(counts["n"] - before)
    r_docs += ref.drain()
    p_docs += port.drain()
    _assert_docs_equal(r_docs, p_docs)
    assert max(per_ingest) <= SYNC_BUDGET
    # the reference's RollupPipeline leaves the pool lanes 18–20 at 0
    # (pipeline.py:423-432; its WindowManager.ingest fills them): the
    # port fills them from the plane — here checked against the
    # reference plane's own counters
    pool_lanes = slice(window.CB_SKETCH_POOL_SPILL, window.CB_LEN)
    assert [b[:pool_lanes.start] for b in r_blocks] == [b[:pool_lanes.start] for b in p_blocks]
    assert all(b[pool_lanes] == [0, 0, 0] for b in r_blocks)
    spill, _, promos = p_blocks[-1][pool_lanes]
    assert (spill, promos) == (int(ref.wm.sk.pool_spill), int(ref.wm.sk.pool_promos))
    assert promos > 0 and port.get_counters()["sketch_promotions"] == promos
    r_sk, p_sk = ref.pop_closed_sketches(), port.pop_closed_sketches()
    assert len(r_sk) == len(p_sk) > 0
    for a, b in zip(r_sk, p_sk):
        _assert_blocks_equal(a, b, "pipeline")


def test_ingest_step_pool_merge_bit_equal():
    """make_ingest_step(fold_mode="merge", sketch_config=<pooled>)
    cycles: stash, ring and every plane field equal the reference's."""
    batch, accum, cap_u, capacity = 384, 2, 256, 2048
    stride = FANOUT_LANES * cap_u
    ref_cfg, cfg = _configs()
    r_append, r_fold = ref_pipeline.make_ingest_step(
        RefFanoutConfig(), interval=1, batch_unique_cap=cap_u, fold_mode="merge",
        sketch_config=ref_cfg, delay=2)
    r_append, r_fold = jax.jit(r_append), jax.jit(r_fold)
    append, fold = pipeline.make_ingest_step(
        FanoutConfig(), interval=1, batch_unique_cap=cap_u, fold_mode="merge",
        sketch_config=cfg, delay=2, device="cpu")
    r_state = ref_stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER)
    r_acc = ref_stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER)
    r_sk = ref_sp.sketch_init(ref_cfg, 4)
    state = stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER, device="cpu")
    acc = stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER, device="cpu")
    sk = sketchplane.sketch_init(cfg, 4, device="cpu")
    from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen

    gen = RefFlowGen(num_tuples=300, seed=2)
    for cycle in range(2):
        for k in range(accum):
            t = T0 + 2 * cycle + k
            fb = gen.flow_batch(batch, t)
            r_state, r_acc, r_sk = r_append(
                r_state, r_acc, jnp.int32(k * stride), r_sk,
                {n: jnp.asarray(v) for n, v in fb.tags.items()}, jnp.asarray(fb.meters),
                jnp.asarray(fb.valid), jnp.uint32(max(0, t - 3)))
            state, acc, sk = append(state, acc, k * stride, sk, fb.tags, fb.meters,
                                    fb.valid, max(0, t - 3))
            _assert_plane_equal(r_sk, sk)
        r_state, r_acc = r_fold(r_state, r_acc)
        state, acc = fold(state, acc)
        _assert_stash_equal(r_state, state)
        _assert_stash_equal(r_acc, acc)
    assert int(sk.pool_promos) > 0 and int(sk.rows) > 0


def test_stream_split_midway_carries_pooled_state():
    """A reference WindowManager's stash, ring and pooled plane carried
    into the port after a promotion: both go on to the same windows."""
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(63)
    batches = _promote_stream(rng)
    kw = dict(capacity=1 << 11, delay=2, fold_mode="merge")
    ref = ref_window.WindowManager(ref_window.WindowConfig(sketch=ref_cfg, **kw))
    port = window.WindowManager(window.WindowConfig(sketch=cfg, **kw), device="cpu")

    def feed(wm, keys, t, ref_side):
        n = len(keys)
        ts, hi, lo, tags, meters, valid = _doc_batch(keys, np.full(n, t), np.ones(n, bool),
                                                     np.full(n, 100.0))
        if ref_side:
            return wm.ingest(ts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
                             jnp.asarray(meters), jnp.asarray(valid))
        return wm.ingest(*(_u32(x) for x in (ts, hi, lo, tags)), torch.from_numpy(meters),
                         torch.from_numpy(valid))

    feed(ref, *batches[0], True)
    assert ref.get_counters()["sketch_promotions"] >= 1
    port.state = convert.stash_from_numpy(_np_state(ref.state), device="cpu")
    port.acc = convert.accum_from_numpy(_np_state(ref.acc), device="cpu")
    port.sk = convert.sketch_from_numpy(_np_state(ref.sk), device="cpu")
    port.fill, port.start_window = ref.fill, ref.start_window
    port._fold_rows_dev = torch.tensor(int(ref._fold_rows_dev))
    r_out, p_out = [], []
    for keys, t in batches[1:]:
        r_out += feed(ref, keys, t, True)
        p_out += feed(port, keys, t, False)
    r_out += ref.flush_all()
    p_out += port.flush_all()
    _assert_flushed_equal(r_out, p_out, "carried")
    assert any(f.sketches is not None for f in p_out)
