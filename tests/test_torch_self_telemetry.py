"""Port of the self-telemetry loop: stage spans over the pipeline and
the checkpoint, the dogfooded deepflow_system round trip (every counter
→ system_sink → the port's store → the port's SQL engine, bit-exact),
the dfstats serializers and the sketch-tier rows against the
reference's on the same inputs, the live overlay providers, and the
sharded manager's telemetry (tests/test_self_telemetry.py's cases)."""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch

from deepflow_tpu.aggregator import sketchplane as ref_sp
from deepflow_tpu.integration import dfstats as ref_dfstats
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu.utils.stats import StatsPoint as RefStatsPoint
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator import sketchplane as port_sp
from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.integration import dfstats
from deepflow_tpu_torch.integration.formats import pack_tags, unpack_tags
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.profiling import DeviceMemoryLedger, StepCostCensus
from deepflow_tpu_torch.profiling import census as census_mod
from deepflow_tpu_torch.querier.engine import QueryEngine
from deepflow_tpu_torch.querier.live import LiveRegistry, QueryResultCache
from deepflow_tpu_torch.storage.store import ColumnarStore
from deepflow_tpu_torch.utils.spans import (
    PIPELINE_SPAN_NAMES,
    SPAN_CHECKPOINT_SAVE,
    SPAN_FLUSH_DRAIN,
    SPAN_INGEST_DISPATCH,
    SPAN_STATS_FETCH,
    SPAN_WINDOW_ADVANCE,
    SpanTracer,
)
from deepflow_tpu_torch.utils.stats import StatsCollector, StatsPoint

torch.set_num_threads(1)

T0 = 1_700_000_000
_SK = dict(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256, topk_rows=2,
           topk_cols=64, pending=8)
_HIST = dict(bins=32, vmin=1.0, gamma=1.3)


def _pipe(sketch=False):
    cfg = SketchConfig(hist=LogHistSpec(**_HIST), **_SK) if sketch else None
    return L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12, sketch=cfg),
                                     batch_size=256), device="cpu")


def _ingest_some(pipe, n_batches=6, batch=128, seed=3):
    gen = SyntheticFlowGen(num_tuples=200, seed=seed)
    for i in range(n_batches):
        pipe.ingest(gen.flow_batch(batch, T0 + i))
    return pipe


def _sql_value(eng, metric):
    res = eng.execute("SELECT value FROM deepflow_system.deepflow_system "
                      f"WHERE metric = '{metric}'")
    assert res.rows == 1, (metric, res.rows)
    return float(res.values["value"][0])


# ---------------------------------------------------------------------------
# stage spans


def test_spans_cover_pipeline_stages_and_checkpoint(tmp_path):
    from deepflow_tpu_torch.aggregator.checkpoint import save_window_state

    pipe = _ingest_some(_pipe())
    save_window_state(pipe.wm, tmp_path / "ckpt.npz")
    pipe.snapshot_open(force=True)
    cache = QueryResultCache(max_entries=4, tracer=pipe.tracer)
    assert cache.lookup(("q", "db", "t"), token=1) is None
    summary = pipe.tracer.summary()
    for name in PIPELINE_SPAN_NAMES:
        assert name in summary, f"missing span {name}: {sorted(summary)}"
        assert summary[name]["count"] > 0
        assert summary[name]["total_us"] >= summary[name]["max_us"] >= 0
    assert summary[SPAN_INGEST_DISPATCH]["count"] == 6
    assert summary[SPAN_STATS_FETCH]["count"] >= 6
    assert summary[SPAN_WINDOW_ADVANCE]["count"] == pipe.get_counters()["window_advances"] < 6
    assert summary[SPAN_FLUSH_DRAIN]["count"] >= 1
    assert summary[SPAN_CHECKPOINT_SAVE]["count"] == 1
    tel = pipe.telemetry()
    json.dumps(tel)  # JSON-able as-is
    assert set(tel) == {"counters", "spans", "profile"}
    assert "jit_retraces" not in tel["counters"]  # no jit cache in eager torch


def test_spans_export_through_an_exporter():
    tracer = SpanTracer(service="unit.pipeline")
    with tracer.span(SPAN_INGEST_DISPATCH):
        pass
    tracer.record(SPAN_FLUSH_DRAIN, 7)
    seen = []

    class Exporter:
        def export(self, table, cols):
            seen.append((table, cols))

    assert tracer.export_otlp(Exporter()) == 2
    table, cols = seen[0]
    assert table == "l7_flow_log"
    assert list(cols["endpoint"]) == [SPAN_INGEST_DISPATCH, SPAN_FLUSH_DRAIN]
    assert list(cols["app_service"]) == ["unit.pipeline"] * 2
    assert len(set(cols["trace_id"])) == 2 and all(len(s) == 32 for s in cols["trace_id"])
    assert all(len(s) == 16 for s in cols["span_id"])
    assert cols["response_duration"][1] == 7
    assert tracer.export_otlp(Exporter()) == 0  # drained


# ---------------------------------------------------------------------------
# the dogfood round trip through the port's SQL engine


def test_pipeline_counters_roundtrip_sql_bit_exact(monkeypatch):
    monkeypatch.setattr(census_mod, "default_census", StepCostCensus())
    pipe = _ingest_some(_pipe(sketch=True))
    led = DeviceMemoryLedger()
    led.register("window_manager", pipe.wm)
    census = pipe._census
    store = ColumnarStore()
    col = StatsCollector(interval_s=999)
    col.register("tpu_pipeline", pipe, kind="L4Pipeline", interval="1s")
    col.register("tpu_pipeline_spans", pipe.tracer, kind="L4Pipeline")
    col.register("tpu_hbm", led)  # held weakly: `led` stays referenced here
    col.register("tpu_step_census", census)
    col.add_sink(dfstats.system_sink(store))
    expected = {
        "tpu_pipeline": pipe.get_counters(),
        "tpu_pipeline_spans": pipe.tracer.get_counters(),
        "tpu_hbm": led.get_counters(),
        "tpu_step_census": census.get_counters(),
    }
    # the ledger counts its own reads: the tick's is the next one
    expected["tpu_hbm"]["snapshots"] += 1
    col.tick(now=float(T0 + 100))
    eng = QueryEngine(store, cache=False, device="cpu")
    assert expected["tpu_pipeline"]["doc_in"] > 0
    assert expected["tpu_hbm"]["sketch_bytes"] > 0
    assert expected["tpu_step_census"]["entries"] == 1
    n = 0
    for module, fields in expected.items():
        for field, value in fields.items():
            metric = dfstats.system_metric_name(module, field)
            assert _sql_value(eng, metric) == float(value), metric
            n += 1
    assert n > 60
    assert _sql_value(eng, "tpu_pipeline_spans_ingest_dispatch_count") == 6.0


def test_system_columns_and_influx_equal_the_reference():
    """The same points through both packages' serializers: identical
    influx text and deepflow_system columns (packed labels included)."""
    spec = [(float(T0), "mod", (("a", "x=y\\z, w"), ("b", "2")),
             {"n": 7, "flag": True, "ratio": 0.5, "nan": float("nan"), "big": 2 ** 53,
              "i": np.int64(9), "f": np.float32(2.0), "name": "text"}),
            (float(T0 + 1), "tpu_pipeline_spans", (), {"stats.fetch.p99_us": 12.5})]
    mine = [StatsPoint(*p) for p in spec]
    ref = [RefStatsPoint(*p) for p in spec]
    assert dfstats.points_to_influx(mine) == ref_dfstats.points_to_influx(ref)
    got = dfstats.points_to_system_columns(mine, extra_tags={"host": "h1"})
    want = ref_dfstats.points_to_system_columns(ref, extra_tags={"host": "h1"})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert unpack_tags(got["labels"][0]) == {"a": "x=y\\z, w", "b": "2", "host": "h1"}
    assert pack_tags({"b": "2", "a": "x"}) == "a=x,b=2"
    store = ColumnarStore()
    dfstats.system_sink(store)(mine)
    rows = store.scan(dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE)
    assert sorted(rows["metric"]) == sorted(want["metric"])  # nan and text skipped


def _random_block(rng, mod, cfg):
    g, m = cfg.num_groups, 1 << cfg.hll_precision
    hll = rng.integers(0, 12, (g, m)).astype(np.int32)
    hll[1] = 0  # a group with no data: no rows
    hist = rng.integers(0, 5, (g, cfg.hist.bins)).astype(np.int64)
    hist[2] = 0  # data but no latency samples: no quantile series
    n_cand = 40
    keys = rng.integers(0, 2 ** 32, (4, n_cand), dtype=np.uint64).astype(np.uint32)
    return mod.WindowSketchBlock(
        window=T0 + 3, config=cfg, n_updates=500, hll=hll,
        cms=rng.integers(0, 900, (cfg.cms_depth, cfg.cms_width)).astype(np.int64),
        hist=hist, tk_hi=keys[0], tk_lo=keys[1], tk_ida=keys[2], tk_idb=keys[3],
        tk_votes=rng.integers(1, 50, n_cand).astype(np.int64))


def test_sketch_block_rows_equal_the_reference():
    ref_cfg = ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), **_SK)
    cfg = SketchConfig(hist=LogHistSpec(**_HIST), **_SK)
    want = ref_dfstats.sketch_block_rows(_random_block(np.random.default_rng(3), ref_sp,
                                                       ref_cfg), 1, topk=8)
    got = dfstats.sketch_block_rows(_random_block(np.random.default_rng(3), port_sp, cfg),
                                    1, topk=8)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-5)
    metrics = {r[1] for r in got}
    assert metrics == {dfstats.SKETCH_METRIC_DISTINCT, dfstats.SKETCH_METRIC_QUANTILE,
                       dfstats.SKETCH_METRIC_TOPK}
    assert not any(r[2].get("service") == "1" for r in got)  # empty group: no series
    assert not any(r[1] == dfstats.SKETCH_METRIC_QUANTILE and r[2]["service"] == "2"
                   for r in got)
    store = ColumnarStore()
    sink = dfstats.sketch_system_sink(store, topk=8)
    sink([_random_block(np.random.default_rng(3), port_sp, cfg)])
    rows = store.scan(dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE)
    assert len(rows["metric"]) == len(got)


def _sink_planes_run(pkg: str):
    """The closed-window sinks with `bus=` and `lineage=` over one set of
    inputs: every published batch (event types and fields) and every
    lineage hop and lag, under a frozen clock."""
    import dataclasses

    if pkg == "ref":
        from deepflow_tpu.aggregator.window import FlushedWindow
        from deepflow_tpu.datamodel.batch import DocBatch
        from deepflow_tpu.datamodel.schema import FLOW_METER as M, TAG_SCHEMA as T
        from deepflow_tpu.querier.events import QueryEventBus, connect_store_events
        from deepflow_tpu.storage.store import ColumnarStore as Store
        from deepflow_tpu.tracing.lineage import FreshnessTracker, LineageTracker
        mod, sp, cfg = ref_dfstats, ref_sp, ref_sp.SketchConfig(hist=RefLogHistSpec(**_HIST), **_SK)
    else:
        from deepflow_tpu_torch.aggregator.window import FlushedWindow
        from deepflow_tpu_torch.datamodel.batch import DocBatch
        from deepflow_tpu_torch.datamodel.schema import FLOW_METER as M, TAG_SCHEMA as T
        from deepflow_tpu_torch.querier.events import QueryEventBus, connect_store_events
        from deepflow_tpu_torch.storage.store import ColumnarStore as Store
        from deepflow_tpu_torch.tracing.lineage import FreshnessTracker, LineageTracker
        mod, sp, cfg = dfstats, port_sp, SketchConfig(hist=LogHistSpec(**_HIST), **_SK)
    clock = [2e9]
    lin = LineageTracker("tpu.pipeline", 1, freshness=FreshnessTracker(autoregister=False),
                         clock=lambda: clock[0])
    store = Store()
    bus = QueryEventBus(name=f"sinks-{pkg}")
    connect_store_events(store, bus)
    batches = []
    bus.subscribe(lambda evs: batches.append(
        [(type(e).__name__, dataclasses.astuple(e)) for e in evs]), name="obs")
    rng = np.random.default_rng(21)
    n = 5
    tags = rng.integers(0, 1000, (n, T.num_fields)).astype(np.uint32)
    meters = rng.integers(0, 100, (n, M.num_fields)).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint64).astype(np.uint32)
    windows = [FlushedWindow(window_idx=T0 + i, start_time=T0 + i, key_hi=keys[0],
                             key_lo=keys[1], tags=tags, meters=meters, count=n)
               for i in range(3)]
    mod.sketch_system_sink(store, bus=bus, topk=8)([_random_block(np.random.default_rng(3),
                                                                  sp, cfg)])
    clock[0] += 1.0
    mod.flow_window_sink(store, bus=bus, lineage=lin)(windows)
    clock[0] += 1.0
    docs = [DocBatch(tags=tags, meters=meters, timestamp=np.full(n, t, np.uint32),
                     valid=np.ones(n, bool), tag_schema=T, meter_schema=M)
            for t in (T0 + 5, T0 + 60)]
    mod.docbatch_window_sink(store, bus=bus, lineage=lin)([docs[0], (60, docs[1])])
    records = {k: ({h: (a.start_s, a.end_s, a.count, a.rows) for h, a in r.hops.items()},
                   dict(r.lags)) for k, r in lin._windows.items()}
    out = (batches, records, lin.freshness.get_counters(), store.row_count(
        mod.DEEPFLOW_SYSTEM_DB, mod.DEEPFLOW_SYSTEM_TABLE))
    lin.close()
    return out


def test_sinks_bus_and_lineage_match_the_reference():
    """`bus=` and `lineage=` of sketch_system_sink, flow_window_sink and
    docbatch_window_sink: the port publishes the reference's event
    batches (one dispatch per sink call, the insert's StoreMutation
    coalesced with the close events) and records its store.insert hops
    and visibility lags."""
    ref, port = _sink_planes_run("ref"), _sink_planes_run("port")
    assert port == ref
    batches, records, fresh, _ = port
    assert len(batches) == 3  # one dispatch per sink call
    assert {k for b in batches for k, _ in b} == {"StoreMutation", "WindowClosed",
                                                  "TierClosed"}
    assert (60, (T0 + 60) // 60) in records and "store.insert" in records[(1, T0)][0]
    assert fresh["1s.visibility_samples"] == 4 and fresh["60s.visibility_samples"] == 1


def test_live_sources_and_window_sinks():
    """The live providers on a registry, and the closed-window sinks
    sharing their row builders: a window's live partial equals its
    flushed rows once its traffic stops."""
    pipe = _pipe()
    gen = SyntheticFlowGen(num_tuples=50, seed=4)
    pipe.ingest(gen.flow_batch(128, T0))
    pipe.ingest(gen.flow_batch(128, T0 + 1))
    reg = LiveRegistry()
    provider, handle = dfstats.live_flow_source(pipe, registry=reg)
    snap = pipe.snapshot_open(force=True)
    live = provider(T0, T0 + 10)
    assert live is not None and provider.epoch() == snap.seq
    partial_t0 = {lab: v for t, lab, v in zip(live["time"], live["labels"], live["value"])
                  if t == T0}
    store = ColumnarStore()
    flushed = pipe.wm.flush_all()
    dfstats.flow_window_sink(store)(flushed)
    rows = store.scan(dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE)
    closed_t0 = {lab: v for t, lab, v in zip(rows["time"], rows["labels"], rows["value"])
                 if t == T0}
    assert partial_t0 and partial_t0 == closed_t0
    reg.unregister(handle)
    dfstats.docbatch_window_sink(store)(pipe._convert_flushed(flushed))
    col = StatsCollector(interval_s=999)
    col.register("tpu_pipeline", pipe, kind="L4Pipeline")
    sys_provider, sys_handle = dfstats.live_system_source(col, registry=reg)
    cols = sys_provider(T0, T0 + 5)
    assert cols is not None and int(cols["time"][0]) == T0 + 4
    got = dict(zip(cols["metric"], cols["value"]))
    assert got["tpu_pipeline_doc_in"] == float(pipe.get_counters()["doc_in"])
    assert sys_provider.epoch() == 1
    reg.unregister(sys_handle)
    pipe.close()


# ---------------------------------------------------------------------------
# the sharded manager


@pytest.mark.parametrize("n_dev", [2])
def test_sharded_manager_telemetry_snapshot(n_dev):
    from deepflow_tpu_torch.parallel import make_mesh
    from deepflow_tpu_torch.parallel.sharded import (
        ShardedConfig,
        ShardedPipeline,
        ShardedWindowManager,
    )

    swm = ShardedWindowManager(ShardedPipeline(
        make_mesh(devices=[torch.device("cpu")] * n_dev),
        ShardedConfig(capacity_per_device=1 << 10, num_services=16, hll_precision=6,
                      hist=LogHistSpec(bins=64, vmin=1.0, gamma=1.3))))
    gen = SyntheticFlowGen(num_tuples=100, seed=9)
    for t in (T0, T0 + 1, T0 + 5):
        fb = gen.flow_batch(64, t)
        swm.ingest(fb.tags, fb.meters, fb.valid)
    swm.drain()
    snap = swm.telemetry()
    json.dumps(snap)
    assert snap["counters"]["flow_in"] > 0
    assert snap["counters"]["host_fetches"] > 0 and snap["counters"]["bytes_uploaded"] > 0
    assert snap["spans"][SPAN_INGEST_DISPATCH]["count"] == 3
    assert SPAN_FLUSH_DRAIN in snap["spans"]
    # ONE window.advance span per advance (close-before / fold-after)
    assert snap["spans"][SPAN_WINDOW_ADVANCE]["count"] == snap["counters"]["window_advances"]
    prof = snap["profile"]
    assert prof["devices"] == n_dev and prof["hbm_bytes"]["stash"] > 0
    assert prof["hbm_bytes"]["sketch"] > 0
    swm.close()
