"""The port's push plane (deepflow_tpu_torch/querier/{events,subscribe,
alerts,promql}.py, the feeder's `event_bus=`, the doc-frame feeder
`WindowManagerFeedSink`) against the JAX package's, on one seeded
stream into each package's own store: the event batches (one dispatch
per pump and per sink insert), the SQL and PromQL subscription results
(integer-valued floats below 2^24 exact, others within rtol 1e-5), the
alert states and transition sequence — a rule over
`tpu_freshness_visibility_lag_ms` included — the doc feeder's windows
bit for bit, and the alert-rules files, each package reading the
other's."""

from __future__ import annotations

import dataclasses
import functools
import time
import types

import numpy as np
import torch

import deepflow_tpu.aggregator.pipeline as ref_pipeline
import deepflow_tpu.aggregator.window as ref_window
import deepflow_tpu.feeder as ref_feeder
import deepflow_tpu.ingest.queues as ref_queues
import deepflow_tpu.ingest.replay as ref_replay
import deepflow_tpu.integration.dfstats as ref_dfstats
import deepflow_tpu.querier.alerts as ref_alerts
import deepflow_tpu.querier.engine as ref_engine
import deepflow_tpu.querier.events as ref_events
import deepflow_tpu.querier.live as ref_live
import deepflow_tpu.querier.promql as ref_promql
import deepflow_tpu.querier.subscribe as ref_subscribe
import deepflow_tpu.storage.store as ref_store
import deepflow_tpu.tracing.lineage as ref_lineage
import deepflow_tpu.utils.stats as ref_stats
import deepflow_tpu_torch.aggregator.pipeline as port_pipeline
import deepflow_tpu_torch.aggregator.window as port_window
import deepflow_tpu_torch.feeder as port_feeder
import deepflow_tpu_torch.ingest.queues as port_queues
import deepflow_tpu_torch.ingest.replay as port_replay
import deepflow_tpu_torch.integration.dfstats as port_dfstats
import deepflow_tpu_torch.querier.alerts as port_alerts
import deepflow_tpu_torch.querier.engine as port_engine
import deepflow_tpu_torch.querier.events as port_events
import deepflow_tpu_torch.querier.live as port_live
import deepflow_tpu_torch.querier.promql as port_promql
import deepflow_tpu_torch.querier.subscribe as port_subscribe
import deepflow_tpu_torch.storage.store as port_store
import deepflow_tpu_torch.tracing.lineage as port_lineage
import deepflow_tpu_torch.utils.stats as port_stats
from deepflow_tpu_torch.datamodel.code import DocumentFlag
from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu_torch.ingest import codec as port_codec
from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame

torch.set_num_threads(1)

T0 = 1_700_000_000
DB = port_dfstats.DEEPFLOW_SYSTEM_DB
TABLE = port_dfstats.DEEPFLOW_SYSTEM_TABLE


def _ns(port, **mods):
    return types.SimpleNamespace(port=port, dev={"device": "cpu"} if port else {}, **mods)


REF = _ns(False, pipeline=ref_pipeline, window=ref_window, feeder=ref_feeder,
          queues=ref_queues, replay=ref_replay, dfstats=ref_dfstats, alerts=ref_alerts,
          engine=ref_engine, events=ref_events, live=ref_live, promql=ref_promql,
          subscribe=ref_subscribe, store=ref_store, lineage=ref_lineage, stats=ref_stats)
PORT = _ns(True, pipeline=port_pipeline, window=port_window, feeder=port_feeder,
           queues=port_queues, replay=port_replay, dfstats=port_dfstats, alerts=port_alerts,
           engine=port_engine, events=port_events, live=port_live, promql=port_promql,
           subscribe=port_subscribe, store=port_store, lineage=port_lineage,
           stats=port_stats)


def _ev(e) -> tuple:
    return (type(e).__name__, dataclasses.astuple(e))


def _recorder(bus):
    batches: list[list] = []
    bus.subscribe(lambda evs: batches.append([_ev(e) for e in evs]), name="obs")
    return batches


def _assert_values_close(got, want):
    """Subscription / query payloads: equal structure; floats that are
    integers below 2^24 exact, others within rtol 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_values_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_values_close(a, b)
    elif isinstance(want, (float, np.floating)):
        if float(want).is_integer() and abs(want) < 2 ** 24:
            assert float(got) == float(want)
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    elif isinstance(want, np.ndarray):
        _assert_values_close(list(got), list(want))
    else:
        assert got == want


# ---------------------------------------------------------------------------
# the bus


def _bus_run(p):
    ev = p.events
    bus = ev.QueryEventBus(name="t1")
    seen = _recorder(bus)
    calls = {"bad": 0}

    def bad(evs):
        calls["bad"] += 1
        raise RuntimeError("boom")

    def chain(evs):
        if any(isinstance(e, ev.WindowClosed) for e in evs):
            bus.publish(ev.StoreMutation("db", "t", 1))  # re-entrant: queued

    bus.subscribe(bad, name="bad")
    bus.subscribe(chain, name="chain")
    out = [bus.publish([ev.WindowClosed("db", "t", T0 + i) for i in range(5)])]
    for i in range(ev.QueryEventBus.MAX_HANDLER_FAILURES + 1):
        out.append(bus.publish(ev.TierClosed("db", "t", T0 - 40, 60)))
    with bus.batch():  # one dispatch for everything published inside
        bus.publish(ev.SnapshotAdvanced("db", "t", 3))
        bus.publish(ev.WindowClosed("db", "t", T0 + 9))

    class _FW:  # FlushedWindow shape
        start_time, interval, count = T0, 0, 3

    class _TW:  # tier window
        start_time, interval = T0 - 40, 60

    class _DB:  # DocBatch shape
        timestamp = np.asarray([T0 + 2, T0 + 2], np.uint32)

    shapes = [_ev(e) for e in ev.docbatch_events([_FW(), _TW(), _DB(), object()],
                                                  db="d", table="t")]
    return seen, out, calls["bad"], bus.get_counters(), shapes


def test_event_bus_delivery_containment_and_shapes_equal():
    ref, port = _bus_run(REF), _bus_run(PORT)
    assert port == ref
    seen, _, bad, counters, shapes = port
    assert len(seen[0]) == 5 and seen[1][0][0] == "StoreMutation"  # re-entrant drained
    assert counters["handlers_detached"] == 1 and bad == port_events.QueryEventBus.MAX_HANDLER_FAILURES
    assert len(shapes) == 3


# ---------------------------------------------------------------------------
# subscriptions over one seeded doc stream


def _doc_batches(seed=11, seconds=6, n=48):
    """A seeded raw-doc stream: (timestamp, key_hi, key_lo, [T, n] tags,
    [M, n] meters, valid) per second, numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(seconds):
        keys = rng.integers(0, 40, n).astype(np.uint32)
        tags = np.zeros((TAG_SCHEMA.num_fields, n), np.uint32)
        tags[TAG_SCHEMA.index("server_port")] = 80 + keys % 7
        tags[TAG_SCHEMA.index("protocol")] = 6
        meters = np.zeros((FLOW_METER.num_fields, n), np.float32)
        meters[FLOW_METER.index("byte_tx")] = rng.integers(1, 5000, n)
        meters[FLOW_METER.index("rtt_sum")] = rng.random(n).astype(np.float32) * 100
        meters[FLOW_METER.index("packet_tx")] = rng.integers(1, 9, n)
        out.append((np.full(n, T0 + 3 * s, np.uint32), keys * np.uint32(2654435761),
                    keys ^ np.uint32(0x9E3779B9), tags, meters, np.ones(n, bool)))
    return out


def _subs_run(p):
    store = p.store.ColumnarStore()
    p.dfstats.ensure_system_table(store)
    bus = p.events.QueryEventBus(name="subs")
    p.events.connect_store_events(store, bus)
    batches = _recorder(bus)
    reg = p.live.LiveRegistry()
    subs = p.subscribe.SubscriptionManager(store, live=reg, cache=False, bus=bus,
                                           name="subs", **p.dev)
    promql_got, sql_got = [], []
    psub, _ = subs.subscribe_promql(
        f"sum by (window) ({p.dfstats.LIVE_METRIC_FLOW_BYTES})", span_s=8, step=1,
        db=DB, table=TABLE, lookback_s=3, callback=lambda r, s: promql_got.append(r))
    ssub, _ = subs.subscribe_sql(
        f"SELECT Sum(value) AS total, Max(value) AS top, Count(value) AS n "
        f"FROM {DB}.{TABLE} WHERE metric = '{p.dfstats.LIVE_METRIC_FLOW_BYTES}'",
        callback=lambda r, s: sql_got.append({c: list(r.values[c]) for c in r.columns}))
    wm = p.window.WindowManager(p.window.WindowConfig(capacity=1 << 10), **p.dev)
    sink = p.dfstats.flow_window_sink(store, bus=bus)
    windows = []
    for b in _doc_batches():
        out = [f for f in wm.ingest(*b) if f.count]
        windows += out
        if out:
            sink(out)
    out = [f for f in wm.flush_all() if f.count]
    windows += out
    sink(out)
    rows = [(f.window_idx, f.key_hi.tobytes(), f.tags.tobytes(), f.meters.tobytes())
            for f in windows]
    counters = {k: v for k, v in subs.get_counters().items()}
    return dict(batches=batches, promql=promql_got, sql=sql_got, rows=rows,
                evals=(psub.evals, ssub.evals, psub.last_now, ssub.last_now),
                counters=counters)


def test_subscriptions_and_sink_events_equal():
    ref, port = _subs_run(REF), _subs_run(PORT)
    assert port["rows"] == ref["rows"] and port["rows"]
    assert port["batches"] == ref["batches"]
    assert port["evals"] == ref["evals"]
    assert port["counters"] == ref["counters"]
    _assert_values_close(port["promql"], ref["promql"])
    _assert_values_close(port["sql"], ref["sql"])
    # one dispatch per sink call: the insert's StoreMutation coalesced
    # with the call's WindowClosed events
    assert all({k for k, _ in b} == {"StoreMutation", "WindowClosed"} for b in port["batches"])
    assert port["evals"][0] == len(port["batches"]) and port["sql"]


# ---------------------------------------------------------------------------
# alerts


SAMPLES = [(0, 50.0), (5, 50.0), (10, 50.0), (12, 60.0), (14, 1.0), (16, 50.0),
           (18, 1.0), (20, 50.0), (26, 50.0), (28, 12.5)]


def _alerts_run(p, tmp_path):
    store = p.store.ColumnarStore()
    p.dfstats.ensure_system_table(store)
    bus = p.events.QueryEventBus(name="a")
    fired: list[dict] = []
    eng = p.alerts.AlertEngine(store, live=p.live.LiveRegistry(), bus=bus, name="a",
                               log_sink=False, **p.dev)
    eng.add_sink(fired.append, name="cb")
    eng.add_rule(p.alerts.AlertRule(name="high_m", query="m", comparator=">",
                                    threshold=10.0, for_s=5, lookback_s=2))
    eng.add_rule(p.alerts.AlertRule(
        name="sum_sql", engine="sql", comparator=">=", threshold=150.0, for_s=0,
        query=f"SELECT Sum(value) AS s FROM {DB}.{TABLE} WHERE metric = 'm'"))
    states = []
    for dt, value in SAMPLES:
        t = T0 + dt
        store.insert(DB, TABLE, {
            "time": np.asarray([t, t], np.uint32),
            "metric": np.asarray(["m", "m"], object),
            "labels": np.asarray(["tier=1s", "tier=60s"], object),
            "value": np.asarray([value, value / 4], np.float64)})
        bus.publish(p.events.WindowClosed(DB, TABLE, t))
        states.append((eng.state("high_m"), eng.state("sum_sql"),
                       [(s["labels"], s["state"]) for s in eng.series_states("high_m")]))
    listing = [{k: v for k, v in r.items()} for r in eng.list_rules()]
    path = tmp_path / ("port" if p.port else "ref")
    eng.save_rules(f"{path}.yaml")
    eng.save_rules(f"{path}.json")
    eng.close()
    return dict(fired=fired, states=states, listing=listing)


def test_alert_states_and_transitions_equal(tmp_path):
    ref, port = _alerts_run(REF, tmp_path), _alerts_run(PORT, tmp_path)
    assert port["states"] == ref["states"]
    _assert_values_close(port["fired"], ref["fired"])
    _assert_values_close(port["listing"], ref["listing"])
    kinds = [(f["rule"], f["state"]) for f in port["fired"]]
    assert ("high_m", "firing") in kinds and ("high_m", "resolved") in kinds
    assert ("sum_sql", "firing") in kinds
    # the rules files: byte-identical, and each package reads the other's
    for suffix in ("yaml", "json"):
        a = (tmp_path / f"ref.{suffix}").read_bytes()
        assert (tmp_path / f"port.{suffix}").read_bytes() == a
        got = port_alerts.load_rules_file(tmp_path / f"ref.{suffix}")
        back = ref_alerts.load_rules_file(tmp_path / f"port.{suffix}")
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in back]
        assert [r.name for r in got] == ["high_m", "sum_sql"]


def _visibility_run(p):
    """A rule over `tpu_freshness_visibility_lag_ms` fires end to end: the
    lineage-attached pipeline's windows land through the lineage sink,
    the freshness lanes tick into deepflow_system, and the insert's
    StoreMutation evaluates the rule (tests/test_lineage.py's drive, the
    lineage under a frozen clock). A StoreMutation carries no data time,
    so the rule evaluates at the wall clock, as the tick's `now` is: the
    notifications are compared without their `time`."""
    clock = [2_000_000_000.0]
    store = p.store.ColumnarStore()
    col = p.stats.StatsCollector()
    fr = p.lineage.FreshnessTracker(autoregister=True, collector=col)
    lin = p.lineage.LineageTracker("tpu.pipeline", 1, freshness=fr, clock=lambda: clock[0])
    pipe = p.pipeline.L4Pipeline(p.pipeline.PipelineConfig(
        window=p.window.WindowConfig(capacity=1 << 12), batch_size=256), **p.dev)
    pipe.attach_lineage(lin)
    wsink = p.dfstats.docbatch_window_sink(store, lineage=lin)
    bus = p.events.QueryEventBus(name="vis")
    p.events.connect_store_events(store, bus)
    batches = _recorder(bus)
    eng = p.alerts.AlertEngine(store, bus=bus, name="lineage", log_sink=False, **p.dev)
    fired = []
    eng.add_sink(fired.append, name="capture")
    eng.add_rule(p.alerts.AlertRule(name="visibility_lag_high",
                                    query="tpu_freshness_visibility_lag_ms",
                                    comparator=">", threshold=1000.0, for_s=0))
    gen = p.replay.SyntheticFlowGen(num_tuples=40, seed=21)
    outs = []
    for i in range(8):
        clock[0] += 1.0
        outs += pipe.ingest(gen.flow_batch(128, T0 + i))
    outs += pipe.drain()
    clock[0] += 1.0
    wsink(outs)
    col.add_sink(p.dfstats.system_sink(store))
    now = int(time.time())
    col.tick(now=now)
    sql = p.engine.QueryEngine(store, cache=False, **p.dev).execute(
        f"SELECT value FROM {DB}.{TABLE} WHERE metric = 'tpu_freshness_visibility_lag_ms'")
    prom = p.promql.query_instant(store, 'tpu_freshness_visibility_lag_ms{tier="1s"}', now,
                                  db=DB, table=TABLE)
    state = eng.state("visibility_lag_high")
    eng.close()
    lin.close()
    return dict(fired=[{k: v for k, v in f.items() if k != "time"} for f in fired],
                state=state, sql=[float(v) for v in sql.values["value"]],
                prom=prom, batches=batches, fresh=fr.get_counters())


def test_visibility_lag_rule_fires_equal():
    ref, port = _visibility_run(REF), _visibility_run(PORT)
    assert port["batches"] == ref["batches"]
    assert port["state"] == ref["state"] == port_alerts.STATE_FIRING
    _assert_values_close(port["fired"], ref["fired"])
    _assert_values_close(port["sql"], ref["sql"])
    _assert_values_close(port["prom"], ref["prom"])
    assert port["fresh"] == ref["fresh"]
    assert port["fired"][0]["labels"].get("tier") == "1s" and port["prom"][0]["value"] > 1000.0


# ---------------------------------------------------------------------------
# the doc-frame feeder


@functools.lru_cache(maxsize=None)
def _metrics_frames() -> tuple:
    """1 s docs of a seeded flow stream, as METRICS frames of 32 docs from
    4 agents, grouped by the second they were made in."""
    gen = port_replay.SyntheticFlowGen(num_tuples=40, seed=9)
    pipe = port_pipeline.L4Pipeline(port_pipeline.PipelineConfig(
        window=port_window.WindowConfig(capacity=1 << 12), batch_size=256), device="cpu")
    groups = []
    for t in range(T0, T0 + 11):
        docs = pipe.ingest(gen.flow_batch(96, t)) if t < T0 + 10 else pipe.drain()
        msgs = [m for db in docs
                for m in port_codec.encode_docbatch(db, flags=int(DocumentFlag.PER_SECOND_METRICS))]
        groups.append(tuple(
            encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1 + k % 4,
                                    organization_id=1), msgs[i:i + 32])
            for k, i in enumerate(range(0, len(msgs), 32))))
    return tuple(groups)


def _doc_feeder_run(p):
    wm = p.window.WindowManager(p.window.WindowConfig(capacity=1 << 12), **p.dev)
    q = p.queues.PyOverwriteQueue(1 << 10)
    bus = p.events.QueryEventBus(name="docfeed")
    batches = _recorder(bus)
    feeder = wm.make_feeder([q], (128, 256), p.feeder.FeederConfig(frames_per_queue=8),
                            event_bus=bus)
    windows = []
    pumps_with_output = 0
    for group in _metrics_frames():
        for frame in group:
            q.put(frame)
        out = feeder.pump()
        pumps_with_output += bool(out)
        windows += out
    out = wm.flush_all()
    windows += out
    sig = [(f.window_idx, f.count, f.key_hi.tobytes(), f.key_lo.tobytes(), f.tags.tobytes(),
            f.meters.tobytes()) for f in windows]
    return dict(windows=sig, batches=batches, pumps=pumps_with_output,
                feeder=feeder.get_counters(), wm=wm.get_counters())


def test_window_manager_feed_sink_windows_and_events_equal():
    ref, port = _doc_feeder_run(REF), _doc_feeder_run(PORT)
    assert port["windows"] == ref["windows"] and port["windows"]
    assert port["batches"] == ref["batches"]
    assert port["feeder"] == ref["feeder"]
    for k in ("doc_in", "flushed_doc", "window_advances", "host_fetches"):
        assert port["wm"][k] == ref["wm"][k], k
    # one bus dispatch per pump that flushed, carrying every window it closed
    assert len(port["batches"]) == port["pumps"] > 0
    assert port["feeder"]["events_published"] == sum(len(b) for b in port["batches"])


def test_feed_sink_host_fingerprint_merges_with_the_device_path():
    """One key fed both ways — the doc feeder's host fingerprint and the
    device fingerprint of a direct ingest — lands in ONE group."""
    from deepflow_tpu_torch.aggregator.pipeline import _doc_fingerprint
    from deepflow_tpu_torch.feeder.runtime import doc_key_fingerprint_np
    from deepflow_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

    from deepflow_tpu_torch.datamodel.code import DOC_KEY_WIDTHS

    rng = np.random.default_rng(4)
    tags = np.zeros((64, TAG_SCHEMA.num_fields), np.uint32)
    for f, width in DOC_KEY_WIDTHS.items():
        # every key field over its width, the last rows past it (the
        # packing's excess word)
        tags[:, TAG_SCHEMA.index(f)] = rng.integers(0, 1 << width, 64, dtype=np.uint64)
        tags[-4:, TAG_SCHEMA.index(f)] = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    hi, lo = doc_key_fingerprint_np(tags)
    dhi, dlo = _doc_fingerprint(from_numpy_u32(tags.T, "cpu"))
    np.testing.assert_array_equal(hi, to_numpy_u32(dhi))
    np.testing.assert_array_equal(lo, to_numpy_u32(dlo))

    wm = port_window.WindowManager(port_window.WindowConfig(capacity=1 << 10), device="cpu")
    meters = np.zeros((1, FLOW_METER.num_fields), np.float32)
    meters[0, FLOW_METER.index("packet_tx")] = 3.0
    one = tags[:1]
    ts = np.full(1, T0, np.uint32)
    sink = port_feeder.WindowManagerFeedSink(wm, (8,))
    out = sink.emit([port_feeder.DocChunk(ts, one, meters)], 1, 8, 0)
    h, l_ = _doc_fingerprint(from_numpy_u32(one.T, "cpu"))
    out += wm.ingest(from_numpy_u32(ts, "cpu"), h, l_, from_numpy_u32(one.T, "cpu"),
                     torch.from_numpy(np.ascontiguousarray(meters.T)),
                     torch.ones(1, dtype=torch.bool))
    out += wm.flush_all()
    rows = [f for f in out if f.count]
    assert len(rows) == 1 and rows[0].count == 1
    assert rows[0].meters[0, FLOW_METER.index("packet_tx")] == 6.0
