"""Port parity for the K-batch counter ring (stats_ring > 1) and async_drain.

The same seeded numpy streams go through the JAX package (CPU backend)
and the port on the CPU, and must come out bit-equal:

  * `_stats_ring_push` on fuzzed counter blocks: the ring and the
    device gate [start_window, opened], with t_max below the delay,
    empty blocks and t_max near 2^32;
  * WindowManager with `stats_ring=4` and with `async_drain` (the
    stream of tests/test_merge_fold.py:255): the windows each ingest
    call returns, full and merge fold, and the counters;
  * K-ring sketch blocks equal the per-batch ones (tests/
    test_sketch_plane.py:144), slab and pooled plane;
  * async output equals sync output one call later (tests/
    test_flush_range.py:226);
  * an empty batch leaves the ring alone, and `flush_all` resyncs the
    device gate, so a straggler after it is late-dropped;
  * L4Pipeline with a K = 4 ring: counter blocks and DocBatches equal the
    reference's, within ⌈B/K⌉ + 2 · advances fetches (tests/
    test_perf_gate.py:314, without the feeder).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import sketchplane as ref_sp
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch.aggregator import pipeline, sketchplane, window
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32
from tests.test_torch_merge_fold import METER, REF_METER, REF_TAGS, TAGS
from tests.test_torch_sketch_plane import (
    _assert_docs_equal,
    _assert_flushed_equal,
    _doc_batch,
    _record_blocks,
)

torch.set_num_threads(1)

T0 = 1_700_000_000
K = 4


def _u32(x):
    return from_numpy_u32(np.asarray(x, np.uint32), "cpu")


# ---------------------------------------------------------------------------
# _stats_ring_push


def _blocks(case: str, rng, n: int) -> np.ndarray:
    """[n, CB_LEN] u32 counter blocks: random lanes, version 7, and the
    t_max / n_valid lanes the gate reads, per case."""
    b = rng.integers(0, 2 ** 32, (n, window.CB_LEN), dtype=np.uint64).astype(np.uint32)
    b[:, window.CB_VERSION] = window.COUNTER_BLOCK_VERSION
    if case == "below_delay":  # t_max < delay, or equal to it
        b[:, window.CB_T_MAX] = rng.integers(0, 4, n)
    elif case == "empty":  # no valid row: the gate holds, however large t_max
        b[:, window.CB_N_VALID] = 0
    elif case == "near_u32_max":
        b[:, window.CB_T_MAX] = np.uint32(2 ** 32 - 1) - rng.integers(0, 5, n).astype(np.uint32)
    else:  # advancing time with some empty and some backwards blocks
        b[:, window.CB_T_MAX] = T0 + np.cumsum(rng.integers(-3, 6, n))
    if case != "empty":
        b[:, window.CB_N_VALID] = np.where(rng.random(n) < 0.2, 0, rng.integers(1, 999, n))
    return b


@pytest.mark.parametrize("case", ["below_delay", "empty", "near_u32_max", "fuzz"])
@pytest.mark.parametrize("interval,delay", [(1, 2), (60, 10)])
def test_stats_ring_push_bit_equal(case, interval, delay):
    """Ten pushes round a K = 4 ring: every ring row and the gate pair
    equal the reference's after each push."""
    rng = np.random.default_rng(len(case) * 7 + interval)
    blocks = _blocks(case, rng, 10)
    sw0 = np.asarray([rng.integers(0, 2 ** 31) if case == "fuzz" else 0, 0], np.uint32)
    r_ring, r_sw = jnp.zeros((K, window.CB_LEN), jnp.uint32), jnp.asarray(sw0)
    ring = torch.zeros((K, window.CB_LEN), dtype=torch.int64)
    sw = _u32(sw0)
    for i, b in enumerate(blocks):
        r_ring, r_sw = ref_window._stats_ring_push(r_ring, jnp.int32(i % K), r_sw,
                                                   jnp.asarray(b), interval=interval,
                                                   delay=delay)
        ring, sw = window._stats_ring_push(ring, i % K, sw, _u32(b), interval=interval,
                                           delay=delay)
        np.testing.assert_array_equal(np.asarray(r_ring), ring.numpy())
        np.testing.assert_array_equal(np.asarray(r_sw), sw.numpy())
    assert int(sw[1]) == int(blocks[:, window.CB_N_VALID].any())


# ---------------------------------------------------------------------------
# WindowManager: the tiny-schema stream of tests/test_merge_fold.py


def _mgr_batch(ts_list, key_list):
    """The reference merge-fold test's manager batch, as numpy."""
    n = len(ts_list)
    ts = np.asarray(ts_list, np.uint32)
    hi = np.asarray(key_list, np.uint32)
    tags = np.stack([hi, hi + 1]).astype(np.uint32)
    meters = np.arange(3 * n, dtype=np.float32).reshape(3, n) * 0.25 + hi[None, :]
    return ts, hi, np.zeros(n, np.uint32), tags, meters, np.ones(n, bool)


def _ref_ingest(wm, batch):
    ts, hi, lo, tags, meters, valid = batch
    return wm.ingest(jnp.asarray(ts), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
                     jnp.asarray(meters), jnp.asarray(valid))


def _port_ingest(wm, batch):
    ts, hi, lo, tags, meters, valid = batch
    return wm.ingest(*(_u32(x) for x in (ts, hi, lo, tags)), torch.from_numpy(meters),
                     torch.from_numpy(valid))


def _window_keys(flushed) -> list:
    return [(f.window_idx, f.count, f.key_hi.tolist(), f.key_lo.tolist(), f.tags.tolist(),
             f.meters.view(np.uint32).tolist()) for f in flushed]


def _tiny_managers(**kw):
    cfg = {**dict(interval=1, delay=2, capacity=256, accum_batches=4), **kw}
    ref = ref_window.WindowManager(ref_window.WindowConfig(**cfg), REF_TAGS, REF_METER)
    port = window.WindowManager(window.WindowConfig(**cfg), TAGS, METER, device="cpu")
    return ref, port


@pytest.mark.parametrize("extra", [{"stats_ring": K}, {"async_drain": True}],
                         ids=["stats_ring", "async"])
def test_window_manager_ring_and_async_bit_equal(extra):
    """Random streams (late rows, multi-window batches, a batch larger
    than the ring that re-inits it mid-stream) through reference and port
    managers under the deferral, full and merge fold: each ingest call
    returns the same windows on both sides (the deferral included), the
    merge fold's equal the full fold's, the counters agree, and nothing
    is left on the device."""
    rng = np.random.default_rng(19)
    for seed in range(2):
        sides = {mode: _tiny_managers(fold_mode=mode, **extra) for mode in ("full", "merge")}
        t = 100 + seed
        got = {mode: [] for mode in sides}
        for step in range(12):
            t += int(rng.integers(0, 3))
            n = 40 if step == 7 else int(rng.integers(1, 14))
            ts = np.maximum(t + rng.integers(-3, 2, n), 0)
            batch = _mgr_batch(ts.tolist(), rng.integers(0, 10, n).tolist())
            for mode, (ref, port) in sides.items():
                r_out, p_out = _ref_ingest(ref, batch), _port_ingest(port, batch)
                assert _window_keys(r_out) == _window_keys(p_out), (seed, step, mode)
                got[mode] += p_out
                assert ref.get_counters()["stats_ring_pending"] == \
                    port.get_counters()["stats_ring_pending"]
        for mode, (ref, port) in sides.items():
            r_out, p_out = ref.flush_all(), port.flush_all()
            assert _window_keys(r_out) == _window_keys(p_out), (seed, mode)
            got[mode] += p_out
            for key in ("drop_before_window", "doc_in", "flushed_doc", "window_advances",
                        "host_fetches", "stats_ring_pending"):
                assert ref.get_counters()[key] == port.get_counters()[key], (mode, key)
            assert port.counters["occupancy"] == 0
        assert _window_keys(got["merge"]) == _window_keys(got["full"]), seed
        assert got["full"]


def test_async_same_output_one_call_later():
    """async_drain returns sync mode's windows, each one ingest call
    later; flush_all settles everything; the reference's async manager
    returns the same windows at the same calls."""
    ref, asy = _tiny_managers(capacity=64, async_drain=True)
    sync = window.WindowManager(window.WindowConfig(interval=1, delay=2, capacity=64),
                                TAGS, METER, device="cpu")
    batches = [([100, 100, 101], [1, 1, 2]), ([103], [3]), ([104, 105], [4, 5]), ([110], [6])]
    got_s, got_a, per_call = [], [], []
    for ts, keys in batches:
        batch = _mgr_batch(ts, keys)
        s_out, a_out = _port_ingest(sync, batch), _port_ingest(asy, batch)
        assert _window_keys(_ref_ingest(ref, batch)) == _window_keys(a_out)
        per_call.append((len(s_out), len(a_out)))
        got_s += s_out
        got_a += a_out
    # async trails by one call: the last batch's closed window is pending
    assert len(got_a) < len(got_s)
    assert [a for _, a in per_call[1:]] == [s for s, _ in per_call[:-1]]
    got_s += sync.flush_all()
    r_tail, a_tail = ref.flush_all(), asy.flush_all()
    assert _window_keys(r_tail) == _window_keys(a_tail)
    got_a += a_tail
    assert _window_keys(got_a) == _window_keys(got_s)
    for field in ("drop_before_window", "total_docs_in", "total_flushed"):
        assert getattr(sync, field) == getattr(asy, field)


def test_empty_batch_keeps_the_ring_and_flush_all_resyncs_the_gate():
    """With K = 4: a 0-row ingest drains no ring block and fetches
    nothing; flush_all drains, then resets the device gate to the host
    span, so a straggler into an emitted window is late-dropped — as in
    the reference, whose gate state matches at every step."""
    ref, port = _tiny_managers(stats_ring=K)
    for ts, keys in (([100, 101], [1, 2]), ([103], [3])):
        assert _window_keys(_ref_ingest(ref, _mgr_batch(ts, keys))) == \
            _window_keys(_port_ingest(port, _mgr_batch(ts, keys)))
    fetches = port.host_fetches
    empty = _mgr_batch([], [])
    assert _ref_ingest(ref, empty) == [] and _port_ingest(port, empty) == []
    assert port.host_fetches == fetches
    assert port.get_counters()["stats_ring_pending"] == 2 == \
        ref.get_counters()["stats_ring_pending"]
    np.testing.assert_array_equal(np.asarray(ref._sw_state), port._sw_state.numpy())
    r_out, p_out = ref.flush_all(), port.flush_all()
    assert _window_keys(r_out) == _window_keys(p_out) and p_out
    assert port.start_window == ref.start_window == 104
    np.testing.assert_array_equal(np.asarray(ref._sw_state), port._sw_state.numpy())
    assert port._sw_state.tolist() == [104, 1]
    straggler = _mgr_batch([102, 103, 104], [7, 8, 9])  # 102, 103 were emitted
    r_late = _ref_ingest(ref, straggler) + ref.flush_all()
    p_late = _port_ingest(port, straggler) + port.flush_all()
    assert _window_keys(r_late) == _window_keys(p_late)
    assert port.drop_before_window == ref.drop_before_window == 2
    assert [f.window_idx for f in p_late] == [104]


# ---------------------------------------------------------------------------
# the sketch plane under the ring


_SK = dict(num_groups=4, hll_precision=8, cms_depth=3, cms_width=512, topk_rows=2,
           topk_cols=128, pending=10)
_HIST = dict(bins=64, vmin=1.0, gamma=1.2)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)


@pytest.mark.parametrize("pool", [False, True], ids=["slab", "pool"])
def test_stats_ring_blocks_bit_exact_vs_per_batch(pool):
    """The plane under a K = 4 ring (tests/test_sketch_plane.py:144):
    flushed windows and every sketch-block lane equal the port's per-
    batch run, and the reference's K = 4 run; merge fold with the pool."""
    rng = np.random.default_rng(52)
    batches = [(rng.integers(0, 200, 256).astype(np.uint32), t)
               for t in (T0, T0, T0 + 1, T0 + 3, T0 + 4, T0 + 4, T0 + 7)]
    r_cfg = ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), **_SK,
                                pool=ref_sp.PoolConfig(**_POOL) if pool else None)
    cfg = sketchplane.SketchConfig(hist=LogHistSpec(**_HIST), **_SK,
                                   pool=sketchplane.PoolConfig(**_POOL) if pool else None)
    kw = dict(capacity=1 << 11, delay=2, fold_mode="merge" if pool else "full")
    ref = ref_window.WindowManager(ref_window.WindowConfig(sketch=r_cfg, stats_ring=K, **kw))
    ports = {k: window.WindowManager(window.WindowConfig(sketch=cfg, stats_ring=k, **kw),
                                     device="cpu") for k in (1, K)}
    r_out, outs = [], {k: [] for k in ports}
    for keys, t in batches:
        n = len(keys)
        ts, hi, lo, tags, meters, valid = _doc_batch(keys, np.full(n, t), np.ones(n, bool),
                                                     np.full(n, 100.0))
        r_out += ref.ingest(ts, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
                            jnp.asarray(meters), jnp.asarray(valid))
        for k, wm in ports.items():
            outs[k] += wm.ingest(*(_u32(x) for x in (ts, hi, lo, tags)),
                                 torch.from_numpy(meters), torch.from_numpy(valid))
    r_out += ref.flush_all()
    for k, wm in ports.items():
        outs[k] += wm.flush_all()
    assert sum(f.sketches is not None for f in outs[K]) >= 4
    _assert_flushed_equal(outs[1], outs[K], "K-ring vs per-batch")
    _assert_flushed_equal(r_out, outs[K], "reference K-ring")
    for key in ("sketch_rows", "sketch_shed", "sketch_promotions", "sketch_pool_spill"):
        assert ports[1].get_counters()[key] == ports[K].get_counters()[key] == \
            ref.get_counters()[key], key
    if pool:
        assert ports[K].get_counters()["sketch_promotions"] > 0


# ---------------------------------------------------------------------------
# L4Pipeline with the ring: counter blocks and the fetch bound


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def test_pipeline_ring_blocks_docs_and_fetch_bound(monkeypatch):
    """L4Pipeline (shape buckets 64/128/256) with a K = 4 ring over 16
    batches, one window advance per 4: DocBatches and every replayed
    counter block equal the reference's K = 4 run, the DocBatches equal a
    per-batch port run's, and the fetches stay within ⌈B/K⌉ + 2 ·
    advances and below one per batch."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    buckets = (64, 128, 256)

    def config(mod, k):
        return mod.PipelineConfig(window=mod.WindowConfig(capacity=1 << 12, stats_ring=k),
                                  batch_size=256, bucket_sizes=buckets)

    ref = ref_pipeline.L4Pipeline(config(ref_pipeline, K))
    port = pipeline.L4Pipeline(config(pipeline, K), device="cpu")
    oracle = pipeline.L4Pipeline(config(pipeline, 1), device="cpu")
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    gen = RefFlowGen(num_tuples=300, seed=11)
    sizes = [60, 120, 250, 40, 200, 64, 90, 256, 30, 180, 128, 70, 250, 55, 140, 33]
    r_docs, p_docs, o_docs = [], [], []
    for i, n in enumerate(sizes):
        fb = gen.flow_batch(n, T0 + i // 4)
        r_docs += ref.ingest(fb)
        before = counts["n"]
        p_docs += port.ingest(_port_batch(fb))
        if i % K != K - 1:  # no ring drain: no fetch at all
            assert counts["n"] == before, i
        o_docs += oracle.ingest(_port_batch(fb))
    p_fetches = port.get_counters()["host_fetches"]
    advances = port.get_counters()["window_advances"]
    assert advances >= 2
    assert p_fetches <= -(-len(sizes) // K) + 2 * advances, (p_fetches, advances)
    assert p_fetches < len(sizes)
    assert p_fetches == ref.get_counters()["host_fetches"]
    r_docs += ref.drain()
    p_docs += port.drain()
    o_docs += oracle.drain()
    _assert_docs_equal(r_docs, p_docs)
    _assert_docs_equal(o_docs, p_docs)
    assert r_blocks == p_blocks and len(p_blocks) == len(sizes)
