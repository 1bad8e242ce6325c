"""Port parity for the whole slice: ingest step, pipelines, state carry.

The same seeded SyntheticFlowGen stream (numpy, one generator per side)
goes through the JAX package (CPU backend) and the port on the CPU:

  * K bench.py-style (append ×2, fold) cycles of `make_ingest_step`
    leave bit-equal stash and ring lanes, overflow included;
  * `L4Pipeline` / `L7Pipeline` emit the same flushed DocBatches and
    the same v7 counter blocks over a multi-window stream with late
    rows;
  * a stream split midway — the reference's stash and ring carried into
    the port through `convert.py` — goes on to the same outputs;
  * the port's host_fetch seam stays within the ≤3-fetches-per-ingest
    budget of tests/test_perf_gate.py;
  * the entry points default to CUDA and raise without it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import stash as ref_stash
from deepflow_tpu.aggregator.fanout import FANOUT_LANES, FanoutConfig as RefFanoutConfig
from deepflow_tpu.aggregator.window import WindowConfig as RefWindowConfig
from deepflow_tpu.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu.ingest.replay import SyntheticAppGen
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import pipeline, stash, window
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

# Each xdist worker imports every test module: one torch thread per
# worker keeps torch's CPU pool from oversubscribing the parallel suite
# (its timing-bound perf-gate tests share the cores).
torch.set_num_threads(1)

T0 = 1_700_000_000
SYNC_BUDGET = 3  # tests/test_perf_gate.py


def _np_state(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _assert_state_equal(ref_state, port_state):
    want = _np_state(ref_state)
    got = (convert.stash_to_numpy if isinstance(port_state, stash.StashState)
           else convert.accum_to_numpy)(port_state)
    assert set(want) == set(got)
    for k, v in want.items():
        if v.dtype == np.float32:
            np.testing.assert_array_equal(v.view(np.uint32), got[k].view(np.uint32), err_msg=k)
        else:
            np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("capacity,cap_u", [(2048, 512), (2048, None), (256, 512)],
                         ids=["prereduce", "raw", "overflow"])
def test_ingest_step_cycles_bit_equal(capacity, cap_u):
    batch, accum = 768, 2
    stride = FANOUT_LANES * (cap_u or batch)
    r_append, r_fold = ref_pipeline.make_ingest_step(
        RefFanoutConfig(), interval=1, batch_unique_cap=cap_u)
    r_append, r_fold = jax.jit(r_append), jax.jit(r_fold)
    append, fold = pipeline.make_ingest_step(
        FanoutConfig(), interval=1, batch_unique_cap=cap_u, device="cpu")
    r_state = ref_stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER)
    r_acc = ref_stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER)
    state = stash.stash_init(capacity, TAG_SCHEMA, FLOW_METER, device="cpu")
    acc = stash.accum_init(accum * stride, TAG_SCHEMA, FLOW_METER, device="cpu")
    r_gen, gen = RefFlowGen(num_tuples=200, seed=2), SyntheticFlowGen(num_tuples=200, seed=2)
    for cycle in range(3):
        for k in range(accum):
            t = T0 + cycle + (k % 2)
            rb, fb = r_gen.flow_batch(batch, t), gen.flow_batch(batch, t)
            r_state, r_acc = r_append(
                r_state, r_acc, jnp.int32(k * stride),
                {n: jnp.asarray(v) for n, v in rb.tags.items()},
                jnp.asarray(rb.meters), jnp.asarray(rb.valid))
            state, acc = append(state, acc, k * stride, fb.tags, fb.meters, fb.valid)
        _assert_state_equal(r_acc, acc)
        r_state, r_acc = r_fold(r_state, r_acc)
        state, acc = fold(state, acc)
        _assert_state_equal(r_state, state)
        _assert_state_equal(r_acc, acc)
    if capacity == 256:
        assert int(state.dropped_overflow) > 0


def _record_blocks(wm) -> list:
    """Capture every counter block a manager processes."""
    blocks = []
    process = wm._process_block

    def record(vec):
        blocks.append([int(v) for v in vec])
        process(vec)

    wm._process_block = record
    return blocks


def _l7_batches(seconds, batch):
    gen = SyntheticAppGen(num_services=16, endpoints_per_service=4, seed=6)
    return [gen.app_batch(batch, T0 + dt) for dt in seconds]


def _flow_batches(seconds, batch, seed=4, sizes=None):
    gen = RefFlowGen(num_tuples=150, seed=seed)
    sizes = sizes or [batch] * len(seconds)
    return [gen.flow_batch(n, T0 + dt) for n, dt in zip(sizes, seconds)]


def _pipes(app: bool, cap_u, capacity=1 << 12, batch=512, buckets=None):
    ref_cls = ref_pipeline.L7Pipeline if app else ref_pipeline.L4Pipeline
    cls = pipeline.L7Pipeline if app else pipeline.L4Pipeline
    ref = ref_cls(ref_pipeline.PipelineConfig(
        window=RefWindowConfig(capacity=capacity, accum_batches=2),
        batch_size=batch, batch_unique_cap=cap_u, bucket_sizes=buckets))
    port = cls(pipeline.PipelineConfig(
        window=WindowConfig(capacity=capacity, accum_batches=2),
        batch_size=batch, batch_unique_cap=cap_u, bucket_sizes=buckets),
        device="cpu")
    return ref, port


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def _assert_docs_equal(ref_docs, port_docs):
    assert len(ref_docs) == len(port_docs) > 0
    for a, b in zip(ref_docs, port_docs):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))
        np.testing.assert_array_equal(a.valid, b.valid)


# late rows: the second "1" arrives after "4" moved the span to window 2;
# the jump to 110 closes every open window in one advance
STREAM = [0, 0, 1, 2, 3, 4, 1, 7, 5, 6, 12, 110]


@pytest.mark.parametrize(
    "app,cap_u,buckets,capacity",
    [(False, None, None, 1 << 12), (False, 256, None, 1 << 12),
     (True, 256, None, 1 << 12), (False, None, (128, 512), 1 << 12),
     (False, 256, None, 300)],
    ids=["l4_raw", "l4_prereduce", "l7_prereduce", "l4_buckets", "l4_overflow"],
)
def test_pipeline_flushes_and_counter_blocks_bit_equal(app, cap_u, buckets, capacity):
    ref, port = _pipes(app, cap_u, capacity=capacity, buckets=buckets)
    r_blocks, p_blocks = _record_blocks(ref.wm), _record_blocks(port.wm)
    # with buckets, batch sizes alternate between the two shape buckets
    sizes = [100 if i % 2 else 400 for i in range(len(STREAM))] if buckets else None
    batches = (_l7_batches(STREAM, 400) if app
               else _flow_batches(STREAM, 400, sizes=sizes))
    r_docs, p_docs = [], []
    for fb in batches:
        r_docs += ref.ingest(fb)
        p_docs += port.ingest(_port_batch(fb))
    assert r_docs  # windows closed mid-stream, not only at the drain
    r_docs += ref.drain()
    p_docs += port.drain()
    _assert_docs_equal(r_docs, p_docs)
    assert r_blocks == p_blocks
    assert r_blocks[0][window.CB_VERSION] == window.COUNTER_BLOCK_VERSION
    r_c, p_c = ref.get_counters(), port.get_counters()
    for key in ("doc_in", "flushed_doc", "drop_before_window", "prereduce_shed",
                "stash_occupancy", "fold_rows", "window_advances"):
        assert r_c[key] == p_c[key], key
    assert p_c["drop_before_window"] > 0
    if capacity < 1 << 12:  # the small stash shed its newest keys, counted
        assert ref.counters["drop_overflow"] == port.counters["drop_overflow"] > 0


def test_stream_split_midway_carries_state_across():
    """Run the reference for half a stream, carry its stash and ring into
    the port with convert.py, then continue both: same outputs."""
    ref, port = _pipes(False, 256)
    batches = _flow_batches(STREAM, 400, seed=9)
    split = 6
    for fb in batches[:split]:
        ref.ingest(fb)
    rw, pw = ref.wm, port.wm
    pw.state = convert.stash_from_numpy(_np_state(rw.state), device="cpu")
    pw.acc = convert.accum_from_numpy(_np_state(rw.acc), device="cpu")
    pw.fill, pw.start_window = rw.fill, rw.start_window
    pw._fold_rows_dev = torch.tensor(int(rw._fold_rows_dev))
    _assert_state_equal(rw.state, pw.state)
    r_blocks, p_blocks = _record_blocks(rw), _record_blocks(pw)
    r_docs, p_docs = [], []
    for fb in batches[split:]:
        r_docs += ref.ingest(fb)
        p_docs += port.ingest(_port_batch(fb))
    r_docs += ref.drain()
    p_docs += port.drain()
    _assert_docs_equal(r_docs, p_docs)
    assert r_blocks == p_blocks


def test_raw_doc_window_manager_bit_equal():
    """WindowManager.ingest (pre-fingerprinted doc rows) on both sides."""
    from deepflow_tpu.aggregator.window import WindowManager as RefWindowManager
    from deepflow_tpu_torch.ops.u32 import from_numpy_u32

    rng = np.random.default_rng(12)
    cfg = dict(capacity=512, accum_batches=2)
    ref = RefWindowManager(RefWindowConfig(**cfg), TAG_SCHEMA, FLOW_METER)
    port = window.WindowManager(WindowConfig(**cfg), TAG_SCHEMA, FLOW_METER, device="cpu")
    r_out, p_out = [], []
    for dt in (0, 1, 0, 3, 2, 5, 1):
        n = 96
        ts = np.full(n, T0 + dt, np.uint32)
        hi = rng.integers(0, 20, n).astype(np.uint32)
        lo = rng.integers(0, 2, n).astype(np.uint32)
        tags = rng.integers(0, 9, (TAG_SCHEMA.num_fields, n)).astype(np.uint32)
        meters = rng.integers(0, 99, (FLOW_METER.num_fields, n)).astype(np.float32)
        valid = rng.random(n) < 0.9
        r_out += ref.ingest(ts, hi, lo, tags, meters, valid)
        p_out += port.ingest(*(from_numpy_u32(x, "cpu") for x in (ts, hi, lo, tags)),
                             torch.from_numpy(meters), torch.from_numpy(valid))
    r_out += ref.flush_all()
    p_out += port.flush_all()
    assert len(r_out) == len(p_out) > 0
    for a, b in zip(r_out, p_out):
        assert (a.window_idx, a.start_time, a.count) == (b.window_idx, b.start_time, b.count)
        for lane in ("key_hi", "key_lo", "tags"):
            np.testing.assert_array_equal(getattr(a, lane), getattr(b, lane))
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))


def test_port_host_fetch_budget(monkeypatch):
    """≤3 device→host fetches per ingest on the port's seam, flat in the
    number of windows a batch closes and in batch size."""
    counts = {"n": 0}
    real_fetch = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        return real_fetch(x)

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    pipe = pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=WindowConfig(capacity=1 << 12), batch_size=256), device="cpu")
    gen = SyntheticFlowGen(num_tuples=200, seed=3)

    def fetches(n_rows: int, t: int) -> int:
        before = counts["n"]
        pipe.ingest(FlowBatch.from_records(gen.records(n_rows, t)))
        return counts["n"] - before

    assert fetches(64, T0) <= SYNC_BUDGET
    one_close = fetches(256, T0 + 4)
    assert one_close <= SYNC_BUDGET
    many_close = fetches(256, T0 + 104)
    assert many_close <= min(SYNC_BUDGET, one_close)
    assert fetches(16, T0 + 105) <= SYNC_BUDGET
    before = counts["n"]
    _ = pipe.counters
    assert counts["n"] - before <= 2
    before = counts["n"]
    c = pipe.get_counters()
    assert counts["n"] - before == 0
    assert c["host_fetches"] > 0 and c["bytes_fetched"] > 0 and c["bytes_uploaded"] > 0


def test_entry_points_default_to_cuda():
    """No device argument means the card: without CUDA that raises
    instead of running the plain CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.L4Pipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_ingest_step(FanoutConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        window.WindowManager(WindowConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.accum_from_numpy({})


@pytest.mark.parametrize("kw", [dict(sketch=object()), dict(cascade=object()),
                                dict(fold_mode="merge"), dict(stats_ring=4),
                                dict(async_drain=True)],
                         ids=["sketch", "cascade", "merge", "stats_ring", "async"])
def test_unported_window_options_raise(kw):
    with pytest.raises(NotImplementedError):
        WindowConfig(**kw)
