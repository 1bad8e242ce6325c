"""The port's window lineage plane (deepflow_tpu_torch/tracing/lineage.py
and the seams of WindowManager, RollupPipeline, ShardedWindowManager and
the feeder) against the JAX package's: one seeded SyntheticFlowGen stream
through both packages under the same frozen clock must give EQUAL span
rows (`drain_spans`), assembled trace trees, hop records, freshness lanes
(counters, histograms, exemplars) and tracker counters — with no
tolerance. Scenarios: per-batch fetching, a K = 4 counter ring, async
drain, the feeder with a receiver / journal / overwrite queue, the
cascade (HOP_CASCADE_CLOSE), a partial snapshot, and a D = 2
ShardedWindowManager on CPU logical shards. Fetch parity: with lineage
attached, `host_fetches` and the flushed stream equal the passive
twin's, in both packages (the port's twin of
`test_perf_gate::test_lineage_tracing_budget`).

Widths are the reference gate's (capacity 1 << 12, batch 256, buckets
(64, 128, 256)). Every scenario's reference run starts at the first test,
all together in worker threads (their JAX compiles dominate the file's
time), and each test reads its own."""

from __future__ import annotations

import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import deepflow_tpu.aggregator.cascade as ref_cascade
import deepflow_tpu.aggregator.pipeline as ref_pipeline
import deepflow_tpu.aggregator.window as ref_window
import deepflow_tpu.feeder as ref_feeder
import deepflow_tpu.feeder.journal as ref_journal
import deepflow_tpu.ingest.framing as ref_framing
import deepflow_tpu.ingest.queues as ref_queues
import deepflow_tpu.ingest.receiver as ref_receiver
import deepflow_tpu.ingest.replay as ref_replay
import deepflow_tpu.integration.dfstats as ref_dfstats
import deepflow_tpu.parallel.mesh as ref_mesh
import deepflow_tpu.parallel.sharded as ref_sharded
import deepflow_tpu.querier.engine as ref_engine
import deepflow_tpu.storage.store as ref_store
import deepflow_tpu.tracing.builder as ref_builder
import deepflow_tpu.tracing.lineage as ref_lineage
import deepflow_tpu_torch.aggregator.cascade as port_cascade
import deepflow_tpu_torch.aggregator.pipeline as port_pipeline
import deepflow_tpu_torch.aggregator.window as port_window
import deepflow_tpu_torch.feeder as port_feeder
import deepflow_tpu_torch.feeder.journal as port_journal
import deepflow_tpu_torch.ingest.framing as port_framing
import deepflow_tpu_torch.ingest.queues as port_queues
import deepflow_tpu_torch.ingest.receiver as port_receiver
import deepflow_tpu_torch.ingest.replay as port_replay
import deepflow_tpu_torch.integration.dfstats as port_dfstats
import deepflow_tpu_torch.parallel.mesh as port_mesh
import deepflow_tpu_torch.parallel.sharded as port_sharded
import deepflow_tpu_torch.querier.engine as port_engine
import deepflow_tpu_torch.storage.store as port_store
import deepflow_tpu_torch.tracing.builder as port_builder
import deepflow_tpu_torch.tracing.lineage as port_lineage

torch.set_num_threads(1)

T0 = 1_700_000_000
CLOCK0 = 2_000_000_000.0


def _ns(pipeline, window, cascade, feeder, journal, framing, queues, receiver, replay,
        dfstats, mesh, sharded, engine, store, builder, lineage, port):
    dev = {"device": "cpu"} if port else {}
    return types.SimpleNamespace(
        pipeline=pipeline, window=window, cascade=cascade, feeder=feeder,
        journal=journal, framing=framing, queues=queues, receiver=receiver,
        replay=replay, dfstats=dfstats, sharded=sharded, engine=engine,
        store=store, builder=builder, lineage=lineage, port=port, dev=dev,
        mesh2=(lambda: mesh.make_mesh(devices=[torch.device("cpu")] * 2, n_hosts=1))
        if port else (lambda: mesh.make_mesh(2, n_hosts=1)),
    )


REF = _ns(ref_pipeline, ref_window, ref_cascade, ref_feeder, ref_journal, ref_framing,
          ref_queues, ref_receiver, ref_replay, ref_dfstats, ref_mesh, ref_sharded,
          ref_engine, ref_store, ref_builder, ref_lineage, False)
PORT = _ns(port_pipeline, port_window, port_cascade, port_feeder, port_journal,
           port_framing, port_queues, port_receiver, port_replay, port_dfstats, port_mesh,
           port_sharded, port_engine, port_store, port_builder, port_lineage, True)


class _FakeClock:
    """Frozen injectable clock: every stamp taken while `t` holds a value
    records exactly that value, in both packages."""

    def __init__(self, t: float):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _tracker(p, clk, service="tpu.pipeline"):
    fr = p.lineage.FreshnessTracker(autoregister=False)
    return p.lineage.LineageTracker(service, 1, freshness=fr, clock=clk), fr


def _l4(p, lineage=None, **wkw):
    pipe = p.pipeline.L4Pipeline(p.pipeline.PipelineConfig(
        window=p.window.WindowConfig(capacity=1 << 12, **wkw), batch_size=256,
        bucket_sizes=(64, 128, 256)), **p.dev)
    if lineage is not None:
        pipe.attach_lineage(lineage)
    return pipe


def _docs(out) -> list:
    """A flushed DocBatch stream, as comparable bytes."""
    return [(int(db.timestamp[0]), db.size, np.asarray(db.tags).tobytes(),
             np.asarray(db.meters).tobytes()) for db in out]


def _sig(lin, fr) -> dict:
    """Everything the lineage plane recorded: per-window hops, lags and
    assembled trees, then the drained span rows, the freshness lanes and
    the tracker's counters."""
    keys = sorted(lin._windows)
    out = {
        "hops": {k: {h: tuple(getattr(a, f) for f in a.__slots__)
                     for h, a in lin._windows[k].hops.items()} for k in keys},
        "lags": {k: dict(lin._windows[k].lags) for k in keys},
        "trees": {k: lin.assemble(k[1], k[0]) for k in keys},
    }
    out["spans"] = [dataclasses.astuple(r) for r in lin.drain_spans()]
    out["fresh"] = fr.get_counters()
    out["hist"] = fr.hist_dump()
    out["exemplars"] = fr.exemplars()
    out["counters"] = lin.get_counters()
    return out


def _freshness_run(p, wkw, lineage: bool):
    """tests/test_lineage.py's oracle drive: one window a batch, the
    clock frozen per call, then a drain."""
    clk = _FakeClock(CLOCK0)
    lin, fr = _tracker(p, clk) if lineage else (None, None)
    pipe = _l4(p, lin, **wkw)
    gen = p.replay.SyntheticFlowGen(num_tuples=60, seed=7)
    out = []
    for i in range(12):
        clk.t = CLOCK0 + 10.0 * i
        out += pipe.ingest(gen.flow_batch(128, T0 + i))
    clk.t = CLOCK0 + 120.0
    out += pipe.drain()
    res = {"docs": _docs(out), "fetches": pipe.wm.host_fetches}
    if lineage:
        res["sig"] = _sig(lin, fr)
        lin.close()
    return res


FETCH_MODES = {"per_batch": {}, "ring4": {"stats_ring": 4}, "async": {"async_drain": True}}


@pytest.mark.parametrize("mode", sorted(FETCH_MODES))
def test_lineage_equal_and_fetch_parity(mode, ref_runs):
    ref = ref_runs[("fresh", mode, True)].result()
    port = _freshness_run(PORT, FETCH_MODES[mode], True)
    assert port["sig"] == ref["sig"]
    assert len(port["sig"]["spans"]) > 0 and port["sig"]["fresh"]["1s.flush_samples"] >= 8
    # fetch parity: the lineage run fetches and flushes exactly what the
    # passive twin does (the reference's passive twin runs once, under the
    # counter ring, where deferred drains meet the dispatch stamps)
    port_passive = _freshness_run(PORT, FETCH_MODES[mode], False)
    assert port["fetches"] == port_passive["fetches"] == ref["fetches"]
    assert port["docs"] == port_passive["docs"] == ref["docs"]
    if mode == "ring4":
        ref_passive = ref_runs[("fresh", mode, False)].result()
        assert ref_passive["fetches"] == ref["fetches"] and ref_passive["docs"] == ref["docs"]


def _partial_run(p):
    clk = _FakeClock(CLOCK0)
    lin, fr = _tracker(p, clk)
    pipe = _l4(p, lin, min_snapshot_interval=0.0)
    gen = p.replay.SyntheticFlowGen(num_tuples=40, seed=5)
    pipe.ingest(gen.flow_batch(96, T0))
    clk.t = CLOCK0 + 5.0
    snap = pipe.snapshot_open(force=True)
    fetches = pipe.wm.host_fetches
    sig = _sig(lin, fr)
    lin.close()
    return [(w.window_idx, w.count, w.partial) for w in snap.windows], fetches, sig


def test_partial_snapshot_lineage_equal(ref_runs):
    ref = ref_runs["partial"].result()
    port = _partial_run(PORT)
    assert port == ref
    windows, _, sig = port
    assert windows and all(partial for *_, partial in windows)
    assert sig["fresh"]["1s.partial_samples"] >= 1
    assert "1s.visibility_samples" not in sig["fresh"]


def _cascade_run(p):
    clk = _FakeClock(CLOCK0)
    lin, fr = _tracker(p, clk)
    pipe = _l4(p, lin, cascade=p.cascade.CascadeConfig(intervals=(60,), capacity=1 << 12))
    gen = p.replay.SyntheticFlowGen(num_tuples=40, seed=13)
    base = (T0 // 60) * 60
    tiers = []
    for i, t in enumerate((base, base + 30, base + 61, base + 70, base + 125)):
        clk.t = CLOCK0 + 10.0 * i
        pipe.ingest(gen.flow_batch(128, t))
        tiers += pipe.pop_tier_docbatches()
    clk.t = CLOCK0 + 100.0
    pipe.drain()
    tiers += pipe.pop_tier_docbatches()
    sig = _sig(lin, fr)
    lin.close()
    return [(iv, *d) for iv, db in tiers for d in _docs([db])], sig


def test_cascade_tier_lineage_equal(ref_runs):
    ref = ref_runs["cascade"].result()
    port = _cascade_run(PORT)
    assert port == ref
    tiers, sig = port
    minute_w = (T0 // 60 * 60) // 60
    assert tiers and port_lineage.HOP_CASCADE_CLOSE in sig["hops"][(60, minute_w)]
    assert "60s.cascade_samples" in sig["fresh"]


def _sharded_pipe(p):
    return p.sharded.ShardedPipeline(p.mesh2(), p.sharded.ShardedConfig(
        capacity_per_device=1 << 11, num_services=16, hll_precision=8,
        cms_width=1 << 10, topk_cols=1 << 6))


def _sharded_run(p, pipe, lineage: bool):
    clk = _FakeClock(CLOCK0)
    lin, fr = _tracker(p, clk) if lineage else (None, None)
    swm = p.sharded.ShardedWindowManager(pipe)
    store = p.store.ColumnarStore()
    if lineage:
        swm.attach_lineage(lin)
    wsink = p.dfstats.docbatch_window_sink(store, lineage=lin)
    gen = p.replay.SyntheticFlowGen(num_tuples=60, seed=9)
    docs = []
    for i in range(8):
        clk.t = CLOCK0 + 10.0 * i
        fb = gen.flow_batch(256, T0 + i)
        out = swm.ingest(fb.tags, fb.meters, fb.valid)
        docs += _docs(out)
        if out:
            clk.t += 1.0
            wsink(out)
    res = {"docs": docs, "fetches": swm.host_fetches}
    if lineage:
        res["sig"] = _sig(lin, fr)
        lin.close()
    return res


def _sharded_pair(p):
    """One pipeline serves the lineage run and its passive twin (each
    manager holds its own state)."""
    pipe = _sharded_pipe(p)
    return _sharded_run(p, pipe, True), _sharded_run(p, pipe, False)


def test_sharded_two_shards_lineage_equal_and_fetch_parity(ref_runs):
    ref, ref_passive = ref_runs["sharded"].result()
    port_pipe = _sharded_pipe(PORT)
    port, passive = _sharded_run(PORT, port_pipe, True), _sharded_run(PORT, port_pipe, False)
    assert port["sig"] == ref["sig"]
    assert port["sig"]["fresh"]["1s.visibility_samples"] >= 4
    assert port["fetches"] == passive["fetches"] == ref["fetches"] == ref_passive["fetches"]
    assert port["docs"] == passive["docs"] == ref["docs"] == ref_passive["docs"]


def _feeder_run(p, tmp, variant: str):
    """receiver → feeder (+ journal) → staged pipeline → store sink →
    first query: the full hop chain. `hostile` interleaves corrupt frames
    admitted at a stale time and floods a 4-deep overwrite queue."""
    clk = _FakeClock(1000.0)
    # a service of its own: query_window_trace looks trackers up in a
    # process-wide registry, where other scenarios' may be live
    service = f"tpu.pipeline.{variant}"
    lin, fr = _tracker(p, clk, service)
    pipe = _l4(p, lin)
    store = p.store.ColumnarStore()
    q = p.queues.PyOverwriteQueue(4 if variant == "hostile" else 1 << 10)
    recv = p.receiver.Receiver()
    recv.lineage = lin
    recv.register_handler(p.framing.MessageType.TAGGEDFLOW, [q])
    journal = (p.journal.FrameJournal(str(tmp / f"{'port' if p.port else 'ref'}.journal"))
               if variant == "journal" else None)
    feeder = p.feeder.FeederRuntime([q], p.feeder.PipelineFeedSink(pipe),
                                    p.feeder.FeederConfig(frames_per_queue=8),
                                    journal=journal, lineage=lin)
    wsink = p.dfstats.docbatch_window_sink(store, lineage=lin)
    p.lineage.connect_store_reads(store, lin, p.dfstats.DEEPFLOW_SYSTEM_DB,
                                  p.dfstats.DEEPFLOW_SYSTEM_TABLE)
    H = p.framing.HEADER_LEN

    def send(frame):
        recv._dispatch(p.framing.FlowHeader.parse(frame[:H]), frame, None)

    gen = p.replay.SyntheticFlowGen(num_tuples=60, seed=3)
    out_docs = []
    for i in range(10):
        clk.t = 1000.0 + 10.0 * i
        frames = p.feeder.encode_flowbatch_frames(gen.flow_batch(128, T0 + i),
                                                  max_rows_per_frame=64)
        reps = 3 if variant == "hostile" else 1
        for frame in frames * reps:
            send(frame)
        if variant == "hostile" and i % 3 == 1:
            clk.t -= 5.0  # admitted at a stale time...
            for _ in range(3):
                send(frames[0][:H] + b"\x00" * (len(frames[0]) - H))
            clk.t += 5.0
        clk.t += 1.0
        out = feeder.pump()
        out_docs += _docs(out)
        if out:
            clk.t += 1.0
            wsink(out)
    clk.t += 1.0
    out = feeder.flush() + pipe.drain()
    out_docs += _docs(out)
    wsink(out)
    clk.t += 1.0
    res = p.engine.QueryEngine(store, cache=False, **p.dev).execute(
        "SELECT value FROM deepflow_system.deepflow_system "
        "WHERE metric = 'deepflow_window_rows'")
    assert res.rows > 0
    trees_before = {w: lin.assemble(w) for w in (T0, T0 + 4)}
    sig = _sig(lin, fr)
    # the drained spans through the store and the builder: the window's
    # tree served from the trace_tree table the builder wrote
    spans = [p.lineage.SpanRow(*r) for r in sig["spans"]]
    builder = p.builder.TraceTreeBuilder(store, close_after_s=0.0,
                                         writer_args={"flush_interval_s": 0.01})
    p.lineage.write_l7_span_rows(store, spans)
    builder.observe(spans)
    builder.tick()
    builder.flush()
    stored_tree = p.lineage.query_window_trace(store, T0, service=service)
    builder.stop()
    counters = {k: v for k, v in feeder.get_counters().items() if not k.startswith("journal_")}
    lin.close()
    return {"docs": out_docs, "sig": sig, "trees": trees_before, "stored": stored_tree,
            "feeder": counters, "fetches": pipe.wm.host_fetches}


FEEDER_VARIANTS = ("journal", "hostile")


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's run of every scenario, submitted together (the
    slowest first) to worker threads; a test waits for its own."""
    tmp = tmp_path_factory.mktemp("ref_lineage")
    jobs = {"sharded": lambda: _sharded_pair(REF), "cascade": lambda: _cascade_run(REF)}
    for mode in FETCH_MODES:
        jobs[("fresh", mode, True)] = lambda m=mode: _freshness_run(REF, FETCH_MODES[m], True)
    jobs[("fresh", "ring4", False)] = lambda: _freshness_run(REF, FETCH_MODES["ring4"], False)
    jobs["partial"] = lambda: _partial_run(REF)
    for v in FEEDER_VARIANTS:
        jobs[("feeder", v)] = lambda v=v: _feeder_run(REF, tmp, v)
    with ThreadPoolExecutor(max_workers=4) as pool:
        yield {k: pool.submit(fn) for k, fn in jobs.items()}


@pytest.mark.parametrize("variant", FEEDER_VARIANTS)
def test_feeder_lineage_equal(variant, tmp_path, ref_runs):
    ref = ref_runs[("feeder", variant)].result()
    port = _feeder_run(PORT, tmp_path, variant)
    assert port["docs"] == ref["docs"] and port["docs"]
    assert port["feeder"] == ref["feeder"]
    assert port["fetches"] == ref["fetches"]
    assert port["sig"] == ref["sig"]
    assert port["trees"] == ref["trees"]
    assert port["stored"] == ref["stored"] and port["stored"] is not None
    hops = {n["app_service"] for n in port["stored"]["nodes"]}
    assert {port_lineage.HOP_RECEIVER_ADMIT, port_lineage.HOP_FEEDER_PUMP,
            port_lineage.HOP_INGEST_DISPATCH, port_lineage.HOP_FLUSH_DRAIN,
            port_lineage.HOP_STORE_INSERT, port_lineage.HOP_QUERY_FIRST} <= hops
    if variant == "journal":
        assert port_lineage.HOP_JOURNAL_APPEND in hops
    if variant == "hostile":
        assert port["feeder"]["bad_frames"] > 0 and port["feeder"]["queue_overwritten"] > 0
    # every admission stamp consumed: by a frame, a bad frame or an
    # overwrite — nothing left to go stale
    assert port["sig"]["counters"]["admit_stamps_pending"] == 0


def test_tensor_input_gives_no_window_span():
    """A torch tensor on any device gives no lineage window span (reading
    it would be a fetch on the card); host numpy gives one."""
    wm = port_window.WindowManager(port_window.WindowConfig(capacity=1 << 10), device="cpu")
    ts = np.array([T0, T0 + 3, T0 + 1], np.uint32)
    valid = np.array([True, False, True])
    assert wm._lineage_span_of(ts, valid) == (T0, T0 + 1)
    assert wm._lineage_span_of(torch.from_numpy(ts.astype(np.int64)), valid) is None
    assert wm._lineage_span_of(ts, torch.from_numpy(valid)) == (T0, T0 + 3)
