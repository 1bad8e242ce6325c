"""Port parity for the per-window sketch plane (slab mode), end to end.

The same seeded numpy streams go through the JAX package (CPU backend;
with DEEPFLOW_FUSED_SKETCH=1 its Pallas kernel runs in interpret mode)
and the port on the CPU. Everything must be bit-equal: the plane state
of `sketch_plane_step` (giant timestamp jumps and pending overflow
included), every flushed exact row and every WindowSketchBlock lane of
`WindowManager.ingest` and `L4Pipeline`, the v7 counter blocks with
their CB_SKETCH_ROWS / CB_SKETCH_SHED lanes, the `make_ingest_step`
state, and a stream whose stash, ring and plane are carried from the
reference into the port midway. The only tolerance is the t-digest's
rtol 1e-5 on the quantile floats.
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
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import pipeline, sketchplane, stash, window
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

torch.set_num_threads(1)

T0 = 1_700_000_000
SYNC_BUDGET = 3  # tests/test_perf_gate.py
QUANTILE_RTOL = 1e-5

_SK = dict(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256, topk_rows=2,
           topk_cols=64, pending=8)
_HIST = dict(bins=32, vmin=1.0, gamma=1.3)


def _configs(**over):
    """(reference SketchConfig, port SketchConfig) of the same shape."""
    kw = {**_SK, **over}
    return (ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), **kw),
            sketchplane.SketchConfig(hist=LogHistSpec(**_HIST), **kw))


_BLOCK_LANES = ("hll", "cms", "hist", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb")


def _assert_blocks_equal(a, b, label):
    assert (a is None) == (b is None), label
    if a is None:
        return
    assert (a.window, a.n_updates) == (b.window, b.n_updates), label
    for lane in _BLOCK_LANES:
        np.testing.assert_array_equal(getattr(a, lane), getattr(b, lane),
                                      err_msg=f"{label}: lane {lane}")
    assert a.distinct() == b.distinct()
    np.testing.assert_array_equal(a.distinct_per_group(), b.distinct_per_group())
    assert a.topk(5) == b.topk(5)
    np.testing.assert_allclose(b.quantile(0.5), a.quantile(0.5), rtol=QUANTILE_RTOL)


def _assert_flushed_equal(ref_out, port_out, label=""):
    assert [f.window_idx for f in ref_out] == [f.window_idx for f in port_out]
    for a, b in zip(ref_out, port_out):
        assert (a.start_time, a.count) == (b.start_time, b.count), label
        for lane in ("key_hi", "key_lo", "tags"):
            np.testing.assert_array_equal(np.asarray(getattr(a, lane)), getattr(b, lane))
        np.testing.assert_array_equal(np.asarray(a.meters).view(np.uint32),
                                      b.meters.view(np.uint32))
        _assert_blocks_equal(a.sketches, b.sketches, f"{label} window {a.window_idx}")


def _assert_plane_equal(ref_sk, port_sk):
    got = convert.sketch_to_numpy(port_sk)
    for k, v in got.items():
        want = np.asarray(getattr(ref_sk, k))
        assert want.dtype == v.dtype, k
        np.testing.assert_array_equal(want, v, err_msg=k)


# ---------------------------------------------------------------------------
# sketch_plane_step


def _plane_inputs(rng, n, windows):
    """One batch of raw plane inputs as numpy (u32 lanes, f32 meters)."""
    u32 = lambda size: rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    kid = rng.integers(0, 30, n)
    rtt = rng.uniform(0.5, 3000, n).astype(np.float32)
    rtt[:3] = [np.nan, np.inf, 0.0]
    weight = rng.integers(0, 600, n).astype(np.float32)
    weight[rng.random(n) < 0.05] = 5e9
    return dict(
        window=np.asarray(windows, np.uint32), valid=rng.random(n) > 0.1,
        group=rng.integers(0, 4, n).astype(np.uint32), client_hi=u32(n), client_lo=u32(n),
        key_hi=(kid * 2654435761 + 1).astype(np.uint32),
        key_lo=(kid ^ 0x9E3779B9).astype(np.uint32), weight=weight, rtt=rtt,
        rtt_valid=rng.random(n) > 0.2, id_a=kid.astype(np.uint32), id_b=u32(n),
    )


def _plane_stream(seed):
    """Batches of (inputs, base_w, close_w): window-spanning batches, a
    late span, a giant jump whose mid-gap rows are shed, and enough
    closes without a drain to overflow a small pending buffer."""
    rng = np.random.default_rng(seed)
    out = []
    sw = 0
    for i, lo_hi in enumerate([(10, 11), (10, 12), (11, 13), (12, 14), (13, 13), (14, 60),
                               (58, 61), (61, 63), (63, 65)]):
        n = 160
        win = rng.integers(lo_hi[0], lo_hi[1] + 1, n)
        x = _plane_inputs(rng, n, win)
        v = win[x["valid"]]
        close_w = max(sw, int(v.max()) - 2) if v.size else sw
        base_w = max(sw, min(int(v.min()), close_w)) if v.size else sw
        out.append((x, base_w, close_w))
        sw = close_w
    return out


# the fused kernel rides the top-K shared sort: no top-K, no kernel
@pytest.mark.parametrize("fused,pending,topk_rows",
                         [(False, 8, 2), (True, 8, 2), (False, 2, 2), (True, 2, 2),
                          (False, 2, 0)],
                         ids=["pend8-xla", "pend8-pallas", "pend_overflow-xla",
                              "pend_overflow-pallas", "no_topk"])
def test_plane_step_state_bit_equal(fused, pending, topk_rows):
    ref_cfg, cfg = _configs(pending=pending, topk_rows=topk_rows)
    ring = 4
    r_sk = ref_sp.sketch_init(ref_cfg, ring)
    sk = sketchplane.sketch_init(cfg, ring, device="cpu")
    u32_keys = ("window", "group", "client_hi", "client_lo", "key_hi", "key_lo", "id_a", "id_b")
    for x, base_w, close_w in _plane_stream(pending * 10 + topk_rows):
        r_sk = ref_sp.sketch_plane_step(
            r_sk, ref_cfg.hist, base_w=jnp.uint32(base_w), close_w=jnp.uint32(close_w),
            shared_sort=True, fused_sketch=fused, **{k: jnp.asarray(v) for k, v in x.items()})
        t = {k: (from_numpy_u32(v, "cpu") if k in u32_keys else torch.from_numpy(v))
             for k, v in x.items()}
        sk = sketchplane.sketch_plane_step(sk, cfg.hist, base_w=base_w, close_w=close_w, **t)
        _assert_plane_equal(r_sk, sk)
    assert int(sk.shed) > 0  # the giant jump's mid-gap rows, counted
    assert int(sk.rows) > 0
    r_sk, r_pend, r_pwin, r_n, _, _ = ref_sp.sketch_drain(r_sk, jnp.uint32(2 ** 32 - 1))
    sk, pend, pwin, n, wide_rows, _ = sketchplane.sketch_drain(sk, 2 ** 32 - 1)
    assert wide_rows is None  # slab mode has no wide arena
    assert int(r_n) == int(n) > 0
    np.testing.assert_array_equal(np.asarray(r_pend)[:int(n)],
                                  pend[:int(n)].numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(r_pwin)[:int(n)], pwin[:int(n)].numpy())
    _assert_plane_equal(r_sk, sk)


# ---------------------------------------------------------------------------
# WindowManager.ingest (the _fuzz_batches stream of test_sketch_onepass.py)


def _doc_batch(keys, ts, valid, weights):
    n = len(keys)
    keys = np.asarray(keys, np.uint32)
    tags = np.zeros((TAG_SCHEMA.num_fields, n), np.uint32)
    tags[TAG_SCHEMA.index("ip0_w3")] = keys
    tags[TAG_SCHEMA.index("server_port")] = 443
    tags[TAG_SCHEMA.index("protocol")] = 6
    tags[TAG_SCHEMA.index("l3_epc_id1")] = keys % 5
    meters = np.zeros((FLOW_METER.num_fields, n), np.float32)
    meters[FLOW_METER.index("byte_tx")] = np.asarray(weights, np.float32)
    meters[FLOW_METER.index("rtt_sum")] = 10.0 + keys
    meters[FLOW_METER.index("rtt_count")] = 1.0
    hi = keys * np.uint32(2654435761) + np.uint32(1)
    lo = keys ^ np.uint32(0x9E3779B9)
    return (np.asarray(ts, np.uint32), hi, lo, tags, meters, np.asarray(valid, bool))


def _fuzz_batches(rng, n_batches, size, key_space):
    """Few-key runs, per-row weights (some ≥ 2^31), ~10% invalid rows,
    every 3rd batch spanning two windows, advancing time."""
    batches = []
    t = T0
    for i in range(n_batches):
        keys = rng.integers(0, key_space, size).astype(np.uint32)
        ts = np.full(size, t, np.uint32)
        if i % 3 == 2:
            ts[size // 2:] = t + 1
        valid = rng.random(size) > 0.1
        weights = rng.integers(1, 500, size).astype(np.float32)
        weights[rng.random(size) < 0.03] = 3e9
        batches.append((keys, ts, valid, weights))
        t += int(rng.integers(0, 3))
    return batches


def _run_managers(monkeypatch, batches, *, fused, ref_cfg, cfg, capacity=1 << 10):
    monkeypatch.setenv("DEEPFLOW_SHARED_SORT", "1")
    monkeypatch.setenv("DEEPFLOW_FUSED_SKETCH", "1" if fused else "0")
    ref = ref_window.WindowManager(ref_window.WindowConfig(
        capacity=capacity, delay=2, sketch=ref_cfg))
    port = window.WindowManager(window.WindowConfig(capacity=capacity, delay=2, sketch=cfg),
                                device="cpu")
    r_out, p_out = [], []
    for keys, ts, valid, weights in batches:
        ts, hi, lo, tags, meters, valid = _doc_batch(keys, ts, valid, weights)
        r_out += ref.ingest(ts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
                            jnp.asarray(meters), jnp.asarray(valid))
        p_out += port.ingest(*(from_numpy_u32(x, "cpu") for x in (ts, hi, lo, tags)),
                             torch.from_numpy(meters), torch.from_numpy(valid))
    r_out += ref.flush_all()
    p_out += port.flush_all()
    return ref, port, r_out, p_out


@pytest.mark.parametrize("fused,seed,size,key_space,topk_rows,capacity",
                         [(False, 171, 193, 30, 2, 1 << 10), (True, 171, 193, 30, 2, 1 << 10),
                          (False, 172, 256, 120, 2, 64), (True, 172, 256, 120, 2, 64),
                          (False, 173, 160, 40, 0, 1 << 10)],
                         ids=["topk-xla", "topk-pallas", "stash_shed-xla",
                              "stash_shed-pallas", "no_topk"])
def test_window_manager_bit_equal(monkeypatch, fused, seed, size, key_space, topk_rows,
                                  capacity):
    ref_cfg, cfg = _configs(topk_rows=topk_rows)
    batches = _fuzz_batches(np.random.default_rng(seed), 5, size, key_space)
    ref, port, r_out, p_out = _run_managers(monkeypatch, batches, fused=fused,
                                            ref_cfg=ref_cfg, cfg=cfg, capacity=capacity)
    assert any(f.sketches is not None for f in r_out)
    _assert_flushed_equal(r_out, p_out, f"seed {seed}")
    r_c, p_c = ref.get_counters(), port.get_counters()
    for key in ("doc_in", "flushed_doc", "sketch_rows", "sketch_shed", "window_advances"):
        assert r_c[key] == p_c[key], key
    assert p_c["sketch_rows"] > 0
    if capacity < 1 << 10:  # the exact stash shed; coverage stayed total
        assert int(port.counters["drop_overflow"]) > 0


def test_sketch_only_window_after_total_shed(monkeypatch):
    """A stash too small for a window's keys: the window's exact rows
    are all shed, and the drain still emits it, sketch-only (count 0)."""
    ref_cfg, cfg = _configs()
    keys = np.arange(300, dtype=np.uint32)
    batches = [(keys, np.full(300, T0, np.uint32), np.ones(300, bool), np.full(300, 9.0)),
               (keys[:40] + 1000, np.full(40, T0 + 1, np.uint32), np.ones(40, bool),
                np.full(40, 9.0)),
               (keys[:8], np.full(8, T0 + 5, np.uint32), np.ones(8, bool), np.full(8, 9.0))]
    ref, port, r_out, p_out = _run_managers(monkeypatch, batches, fused=False,
                                            ref_cfg=ref_cfg, cfg=cfg, capacity=16)
    _assert_flushed_equal(r_out, p_out, "tiny stash")
    assert any(f.count == 0 and f.sketches is not None for f in p_out)


# ---------------------------------------------------------------------------
# L4Pipeline and make_ingest_step


def _record_blocks(wm) -> list:
    blocks = []
    process = wm._process_block

    def record(vec):
        blocks.append([int(v) for v in vec])
        process(vec)

    wm._process_block = record
    return blocks


def _pipes(monkeypatch, fused, cap_u=256, capacity=1 << 12, batch=400, **sk_over):
    monkeypatch.setenv("DEEPFLOW_SHARED_SORT", "1")
    monkeypatch.setenv("DEEPFLOW_FUSED_SKETCH", "1" if fused else "0")
    ref_cfg, cfg = _configs(**sk_over)
    ref = ref_pipeline.L4Pipeline(ref_pipeline.PipelineConfig(
        window=ref_window.WindowConfig(capacity=capacity, accum_batches=2, sketch=ref_cfg),
        batch_size=batch, batch_unique_cap=cap_u))
    port = pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=window.WindowConfig(capacity=capacity, accum_batches=2, sketch=cfg),
        batch_size=batch, batch_unique_cap=cap_u), device="cpu")
    return ref, port


def _flow_batches(seconds, batch, seed):
    gen = RefFlowGen(num_tuples=150, seed=seed)
    return [gen.flow_batch(batch, T0 + dt) for dt in seconds]


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def _assert_docs_equal(ref_docs, port_docs):
    assert len(ref_docs) == len(port_docs) > 0
    for a, b in zip(ref_docs, port_docs):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))


# late rows (the second 1) and a jump that closes every open window
STREAM = [0, 0, 1, 2, 3, 4, 1, 7, 5, 6, 12, 60]


@pytest.mark.parametrize("fused,cap_u", [(False, 256), (True, 256), (False, None)],
                         ids=["xla_prereduce", "pallas_prereduce", "xla_raw"])
def test_pipeline_blocks_and_counter_lanes_bit_equal(monkeypatch, fused, cap_u):
    ref, port = _pipes(monkeypatch, fused, cap_u=cap_u)
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    r_docs, p_docs = [], []
    for fb in _flow_batches(STREAM, 400, seed=4):
        r_docs += ref.ingest(fb)
        p_docs += port.ingest(_port_batch(fb))
    r_docs += ref.drain()
    p_docs += port.drain()
    _assert_docs_equal(r_docs, p_docs)
    assert r_blocks == p_blocks
    assert p_blocks[-1][window.CB_SKETCH_ROWS] > 0
    r_sk, p_sk = ref.pop_closed_sketches(), port.pop_closed_sketches()
    assert len(r_sk) == len(p_sk) > 0 and port.closed_sketches == []
    for a, b in zip(r_sk, p_sk):
        _assert_blocks_equal(a, b, "pipeline")
    r_c, p_c = ref.get_counters(), port.get_counters()
    for key in ("sketch_rows", "sketch_shed", "sketch_blocks_held", "sketch_blocks_dropped",
                "doc_in", "flushed_doc", "drop_before_window"):
        assert r_c[key] == p_c[key], key


def test_pipeline_held_blocks_drop_oldest_counted(monkeypatch):
    ref, port = _pipes(monkeypatch, False)
    ref.max_held_sketches = port.max_held_sketches = 2
    for fb in _flow_batches([0, 1, 2, 3, 4, 5, 6, 7], 200, seed=5):
        ref.ingest(fb)
        port.ingest(_port_batch(fb))
    assert port.sketch_blocks_dropped == ref.sketch_blocks_dropped > 0
    assert [b.window for b in port.closed_sketches] == [b.window for b in ref.closed_sketches]


def _np_state(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _assert_stash_equal(ref_state, port_state):
    got = (convert.stash_to_numpy if isinstance(port_state, stash.StashState)
           else convert.accum_to_numpy)(port_state)
    for k, v in _np_state(ref_state).items():
        if v.dtype == np.float32:
            np.testing.assert_array_equal(v.view(np.uint32), got[k].view(np.uint32), err_msg=k)
        else:
            np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas"])
def test_ingest_step_sketch_cycles_bit_equal(monkeypatch, fused):
    monkeypatch.setenv("DEEPFLOW_SHARED_SORT", "1")
    monkeypatch.setenv("DEEPFLOW_FUSED_SKETCH", "1" if fused else "0")
    batch, accum, cap_u, capacity = 384, 2, 256, 2048
    stride = FANOUT_LANES * cap_u
    ref_cfg, cfg = _configs()
    r_append, r_fold = ref_pipeline.make_ingest_step(
        RefFanoutConfig(), interval=1, batch_unique_cap=cap_u, sketch_config=ref_cfg, delay=2)
    r_append, r_fold = jax.jit(r_append), jax.jit(r_fold)
    append, fold = pipeline.make_ingest_step(
        FanoutConfig(), interval=1, batch_unique_cap=cap_u, sketch_config=cfg, delay=2,
        device="cpu")
    r_state = ref_stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER)
    r_acc = ref_stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER)
    r_sk = ref_sp.sketch_init(ref_cfg, 4)
    state = stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER, device="cpu")
    acc = stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER, device="cpu")
    sk = sketchplane.sketch_init(cfg, 4, device="cpu")
    gen = RefFlowGen(num_tuples=200, seed=2)
    for cycle in range(3):
        for k in range(accum):
            t = T0 + 2 * cycle + k
            fb = gen.flow_batch(batch, t)
            sw = max(0, t - 3)
            r_state, r_acc, r_sk = r_append(
                r_state, r_acc, jnp.int32(k * stride), r_sk,
                {n: jnp.asarray(v) for n, v in fb.tags.items()}, jnp.asarray(fb.meters),
                jnp.asarray(fb.valid), jnp.uint32(sw))
            state, acc, sk = append(state, acc, k * stride, sk, fb.tags, fb.meters,
                                    fb.valid, sw)
        _assert_plane_equal(r_sk, sk)
        r_state, r_acc = r_fold(r_state, r_acc)
        state, acc = fold(state, acc)
        _assert_stash_equal(r_state, state)
        _assert_stash_equal(r_acc, acc)
    assert int(sk.pend_n) > 0 and int(sk.rows) > 0


def test_stream_split_midway_carries_sketch_state(monkeypatch):
    """Run the reference pipeline for half a stream, carry its stash,
    ring and sketch plane into the port with convert.py, continue both:
    same DocBatches, sketch blocks and counter blocks."""
    ref, port = _pipes(monkeypatch, False)
    batches = _flow_batches(STREAM, 400, seed=9)
    split = 6
    for fb in batches[:split]:
        ref.ingest(fb)
    ref.pop_closed_sketches()
    rw, pw = ref.wm, port.wm
    assert rw._sketch_blocks == {}
    pw.state = convert.stash_from_numpy(_np_state(rw.state), device="cpu")
    pw.acc = convert.accum_from_numpy(_np_state(rw.acc), device="cpu")
    pw.sk = convert.sketch_from_numpy(_np_state(rw.sk), device="cpu")
    pw.fill, pw.start_window = rw.fill, rw.start_window
    pw._fold_rows_dev = torch.tensor(int(rw._fold_rows_dev))
    _assert_plane_equal(rw.sk, pw.sk)
    r_blocks, p_blocks = _record_blocks(rw), _record_blocks(pw)
    r_docs, p_docs = [], []
    for fb in batches[split:]:
        r_docs += ref.ingest(fb)
        p_docs += port.ingest(_port_batch(fb))
    r_docs += ref.drain()
    p_docs += port.drain()
    _assert_docs_equal(r_docs, p_docs)
    assert r_blocks == p_blocks
    r_sk, p_sk = ref.pop_closed_sketches(), port.pop_closed_sketches()
    assert len(r_sk) == len(p_sk) > 0
    for a, b in zip(r_sk, p_sk):
        _assert_blocks_equal(a, b, "carried")


def test_convert_refuses_pooled_state():
    """A pooled plane crosses with every pool field; one whose slot map
    names an arena slot the state does not hold is refused."""
    pooled = ref_sp.SketchConfig(
        num_groups=4, hll_precision=7, cms_depth=2, cms_width=256,
        hist=RefLogHistSpec(**_HIST), topk_rows=2, topk_cols=64, pending=8,
        pool=ref_sp.PoolConfig(compact_slots=2, wide_slots=1))
    d = _np_state(ref_sp.sketch_init(pooled, 4))
    _assert_plane_equal(ref_sp.sketch_init(pooled, 4),
                        convert.sketch_from_numpy(d, device="cpu"))
    d["slot_of"] = np.array([0, 3, -1, -1], np.int32)  # 2 compact + 1 wide: no slot 3
    with pytest.raises(ValueError, match="pool"):
        convert.sketch_from_numpy(d, device="cpu")


def test_sketch_fetch_budget(monkeypatch):
    """≤3 device→host fetches per ingest with the sketch plane on, flat
    in the number of windows a batch closes."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    _, port = _pipes(monkeypatch, False, batch=256)
    gen = RefFlowGen(num_tuples=200, seed=3)
    per_ingest = []
    for dt in (0, 1, 4, 5, 104, 105):
        before = counts["n"]
        port.ingest(_port_batch(gen.flow_batch(256, T0 + dt)))
        per_ingest.append(counts["n"] - before)
    assert max(per_ingest) <= SYNC_BUDGET
    assert per_ingest[4] == SYNC_BUDGET  # the jump closes every window: still 3
    assert port.pop_closed_sketches()


def test_sketch_entry_points_default_to_cuda_and_pool_raises():
    _, cfg = _configs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sketchplane.sketch_init(cfg, 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.L4Pipeline(pipeline.PipelineConfig(window=window.WindowConfig(sketch=cfg)))
    with pytest.raises(TypeError, match="PoolConfig"):
        sketchplane.SketchConfig(pool=object())
    with pytest.raises(TypeError):
        window.WindowConfig(sketch=object())
