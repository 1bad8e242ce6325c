"""The port's fleet telemetry plane (deepflow_tpu_torch/fleet) against the
reference's: the cases of tests/test_fleet.py that need no server, REST,
config or CLI — the frame codec, the summary-domain merge algebra
(`merge_hist_dumps`, `worst_state`, `SpanTracer.hist_dump`), guarded
exporter faces, aggregator merge and staleness with an injected clock,
the skew surfaces, store rows queried through the SQL and PromQL planes
— each run on both packages with the same script and held equal, plus
frames across packages: every frame the port encodes is byte-equal to
the reference's and decodes in either package to the same frame, and
the two aggregators fed the same frames merge to the same counters,
hists, alerts and skew. The two-process fleet proofs live beside their
recipe in tests/test_torch_mesh_multiproc.py."""

from __future__ import annotations

import json
import types

import pytest

from deepflow_tpu import fleet as ref_fleet
from deepflow_tpu.ingest import framing as ref_framing
from deepflow_tpu.querier import alerts as ref_alerts
from deepflow_tpu.tracing import lineage as ref_lineage
from deepflow_tpu.utils import spans as ref_spans
from deepflow_tpu.utils import stats as ref_stats
from deepflow_tpu_torch import fleet
from deepflow_tpu_torch.ingest import framing
from deepflow_tpu_torch.querier import alerts
from deepflow_tpu_torch.tracing import lineage
from deepflow_tpu_torch.utils import spans, stats

PORT = types.SimpleNamespace(name="port", fleet=fleet, framing=framing, alerts=alerts,
                             lineage=lineage, spans=spans, stats=stats)
REF = types.SimpleNamespace(name="ref", fleet=ref_fleet, framing=ref_framing,
                            alerts=ref_alerts, lineage=ref_lineage, spans=ref_spans,
                            stats=ref_stats)


def _both(fn):
    return fn(PORT), fn(REF)


def _full_frame(pkg):
    return pkg.fleet.FleetFrame(
        host="h0", group="1", epoch=3, seq=7, timestamp=123.5,
        points=((100.0, "tpu_mesh_swm", {"group": "1"},
                 {"flow_in": 41, "rate": 1.5}),),
        hists={"g1": {"1s.e2e": [[3, 4], [9, 2]]}},
        alerts=({"name": "lag", "state": "firing", "value": 2.0,
                 "transitions": 1},),
        hbm=({"module": "window", "plane": "ring", "bytes": 1 << 20},),
        census={"entries": 2, "compiles": 5},
    )


def _as_tuple(f) -> tuple:
    return (f.host, f.group, f.epoch, f.seq, f.timestamp, f.points, f.hists, f.alerts,
            f.hbm, f.census)


# ---------------------------------------------------------------------------
# codec


def test_fleet_frame_roundtrip():
    def run(pkg):
        f = _full_frame(pkg)
        raw = pkg.fleet.encode_fleet_frame(f)
        asm = pkg.framing.FrameReassembler()
        [(header, body)] = asm.feed(raw)
        g = pkg.fleet.decode_fleet_frame(header, body)
        assert g == pkg.fleet.FleetFrame(
            host=f.host, group=f.group, epoch=f.epoch, seq=f.seq,
            timestamp=f.timestamp, points=f.points, hists=f.hists,
            alerts=f.alerts, hbm=f.hbm, census=f.census,
        )
        assert asm.bad_frames == 0
        return raw, _as_tuple(g)

    port, ref = _both(run)
    assert port == ref  # byte-equal frames, equal decodes


def test_fleet_frame_rejects_wrong_type_and_version():
    def run(pkg):
        fr = pkg.framing
        raw = pkg.fleet.encode_fleet_frame(
            pkg.fleet.FleetFrame(host="h", group="", epoch=0, seq=0, timestamp=0.0))
        [(header, body)] = fr.FrameReassembler().feed(raw)
        bad = fr.FlowHeader(msg_type=int(fr.MessageType.TAGGEDFLOW))
        with pytest.raises(ValueError) as e1:
            pkg.fleet.decode_fleet_frame(bad, body)
        wrong_v = fr.encode_frame(fr.FlowHeader(msg_type=int(fr.MessageType.DFSTATS)),
                                  [json.dumps({"v": 99}).encode()])
        [(h2, b2)] = fr.FrameReassembler().feed(wrong_v)
        with pytest.raises(ValueError) as e2:
            pkg.fleet.decode_fleet_frame(h2, b2)
        return str(e1.value), str(e2.value), wrong_v

    port, ref = _both(run)
    assert port == ref


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_fleet_frames_cross_packages(direction):
    """Encode in one package, decode in the other: the same frame, and
    the encoders' bytes equal."""
    enc, dec = (PORT, REF) if direction == "port_to_ref" else (REF, PORT)
    raws = [enc.fleet.encode_fleet_frame(f) for f in (
        _full_frame(enc), _frame(enc, "h1", "0", 1000, {"flow_in": 32}, [[1, 1], [4, 5]],
                                 state="firing"))]
    assert raws == [dec.fleet.encode_fleet_frame(f) for f in (
        _full_frame(dec), _frame(dec, "h1", "0", 1000, {"flow_in": 32}, [[1, 1], [4, 5]],
                                 state="firing"))]
    for raw, want in zip(raws, (_full_frame(dec), _frame(dec, "h1", "0", 1000,
                                                          {"flow_in": 32},
                                                          [[1, 1], [4, 5]],
                                                          state="firing"))):
        [(header, body)] = dec.framing.FrameReassembler().feed(raw)
        assert _as_tuple(dec.fleet.decode_fleet_frame(header, body)) == _as_tuple(want)


# ---------------------------------------------------------------------------
# merge algebra


def test_merge_hist_dumps_sums_bin_for_bin():
    def run(pkg):
        merge = pkg.lineage.merge_hist_dumps
        a = {"1s.e2e": [[1, 2], [5, 3]], "1s.store": [[0, 1]]}
        b = {"1s.e2e": [[1, 1], [7, 4]]}
        got = merge(a, b)
        assert got == {"1s.e2e": [[1, 3], [5, 3], [7, 4]], "1s.store": [[0, 1]]}
        # identity + associativity on the empty dump
        assert merge(a) == merge(a, {})
        return got

    port, ref = _both(run)
    assert port == ref


def test_worst_state_rollup():
    def run(pkg):
        al = pkg.alerts
        cases = ([], [al.STATE_INACTIVE, al.STATE_RESOLVED],
                 [al.STATE_PENDING, al.STATE_RESOLVED],
                 [al.STATE_INACTIVE, al.STATE_FIRING, al.STATE_PENDING],
                 ["???", al.STATE_PENDING])
        got = [al.worst_state(c) for c in cases]
        assert got == [al.STATE_INACTIVE, al.STATE_RESOLVED, al.STATE_PENDING,
                       al.STATE_FIRING, al.STATE_PENDING]
        return got

    port, ref = _both(run)
    assert port == ref


def test_span_tracer_hist_dump_matches_freshness_shape():
    def run(pkg):
        tr = pkg.spans.SpanTracer()
        for us in (10, 10, 5000):
            tr.record("fold", us)
        tr.record("drain", 77)
        dump = tr.hist_dump()
        assert set(dump) == {"fold", "drain"}
        assert sum(c for _b, c in dump["fold"]) == 3
        assert all(c > 0 for lane in dump.values() for _b, c in lane)
        # the dump merges with itself through the same fleet algebra
        doubled = pkg.lineage.merge_hist_dumps(dump, dump)
        assert sum(c for _b, c in doubled["fold"]) == 6
        return dump, doubled

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# exporter


def test_exporter_builds_guarded_faces():
    def run(pkg):
        col = pkg.stats.StatsCollector()

        class Swm:
            def get_counters(self):
                return {"flow_in": 11}

        swm = Swm()
        col.register("tpu_mesh_swm", swm, group="0")

        class BrokenFace:
            def hist_dump(self):
                raise RuntimeError("boom")

        class GoodFace:
            def hist_dump(self):
                return {"1s.e2e": [[2, 9]]}

        exp = pkg.fleet.FleetExporter(
            "hostA", group="0", epoch=2, collector=col,
            hist_faces={"bad": BrokenFace(), "g0": GoodFace()},
            clock=lambda: 500.0,
        )
        f1 = exp.build()
        f2 = exp.build()
        assert f1.host == "hostA" and f1.epoch == 2
        assert (f1.seq, f2.seq) == (0, 1)
        assert f1.hists == {"g0": {"1s.e2e": [[2, 9]]}}  # broken face skipped
        assert exp.get_counters()["face_errors"] >= 2
        [pt] = [p for p in f1.points if p[1] == "tpu_mesh_swm"]
        assert pt[3] == {"flow_in": 11}
        return _as_tuple(f1), _as_tuple(f2), exp.get_counters(), \
            pkg.fleet.encode_fleet_frame(f1)

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# aggregator: merge + staleness (injected clock)


def _frame(pkg, host, group, t, fields, hist_pairs, *, seq=0, state="inactive"):
    return pkg.fleet.FleetFrame(
        host=host, group=group, epoch=0, seq=seq, timestamp=float(t),
        points=((float(t), "tpu_mesh_swm", {"group": group}, dict(fields)),),
        hists={f"g{group}": {"1s.e2e": [list(p) for p in hist_pairs]}},
        alerts=({"name": "lag", "state": state, "value": 1.0,
                 "transitions": 0},),
    )


def test_aggregator_merges_and_expires_staleness_counted():
    def run(pkg):
        views = []
        clock = {"t": 1000.0}
        agg = pkg.fleet.FleetAggregator(expiry_s=30.0, clock=lambda: clock["t"],
                                        autoregister=False)
        agg.ingest(_frame(pkg, "h0", "0", 1000, {"flow_in": 10}, [[1, 2]]))
        agg.ingest(_frame(pkg, "h1", "0", 1000, {"flow_in": 32}, [[1, 1], [4, 5]],
                          state="firing"))
        both = agg.merged_counters()
        assert both == {"tpu_mesh_swm{group=0}.flow_in": 42}
        assert isinstance(both["tpu_mesh_swm{group=0}.flow_in"], int)  # bit-exact
        assert agg.merged_hists() == {"g0.1s.e2e": [[1, 3], [4, 5]]}
        [rule] = agg.merged_alerts()
        assert rule["state"] == "firing"  # one firing host fires the fleet
        views.append((both, agg.merged_hists(), agg.merged_alerts()))

        # h1 goes quiet past expiry_s: EXPIRED from merges, counted, stamped
        clock["t"] = 1020.0
        agg.ingest(_frame(pkg, "h0", "0", 1020, {"flow_in": 15}, [[1, 3]], seq=1))
        clock["t"] = 1045.0
        only_h0 = agg.merged_counters()
        assert only_h0 == {"tpu_mesh_swm{group=0}.flow_in": 15}
        assert agg.merged_hists() == {"g0.1s.e2e": [[1, 3]]}
        [rule] = agg.merged_alerts()
        assert rule["state"] == "inactive"  # the firing host is gone, loudly
        c = agg.get_counters()
        assert c["hosts_expired"] == 1
        assert c["stale_drops"] >= 3  # each read that withheld h1 counted
        roster = {r["host"]: r for r in agg.hosts()}
        assert roster["h1"]["stale"] is True
        assert roster["h1"]["last_seen"] == 1000.0  # stamp retained
        assert roster["h0"]["stale"] is False
        views.append((only_h0, c, roster))

        # a new frame RECOVERS the host (counted) and it rejoins the merge
        agg.ingest(_frame(pkg, "h1", "0", 1045, {"flow_in": 40}, [[4, 6]], seq=1))
        assert agg.merged_counters() == {"tpu_mesh_swm{group=0}.flow_in": 55}
        assert agg.get_counters()["hosts_recovered"] == 1
        views.append((agg.merged_counters(), agg.merged_hists(), agg.get_counters(),
                      agg.health()))
        return views

    port, ref = _both(run)
    assert port == ref


def test_aggregator_skew_surfaces():
    def run(pkg):
        clock = {"t": 2000.0}
        agg = pkg.fleet.FleetAggregator(expiry_s=300.0, clock=lambda: clock["t"],
                                        autoregister=False)

        def freshness_frame(host, lag_ms, hbm_bytes, t, flow_in, seq):
            return pkg.fleet.FleetFrame(
                host=host, group="0", epoch=0, seq=seq, timestamp=float(t),
                points=(
                    (float(t), "tpu_freshness", {"tier": "1s"}, {"e2e_lag_ms": lag_ms}),
                    (float(t), "tpu_mesh_swm", {"group": "0"}, {"flow_in": flow_in}),
                ),
                hbm=({"module": "w", "bytes": hbm_bytes},),
            )

        # two frames per host so the rate lane has a delta
        agg.ingest(freshness_frame("h0", 5.0, 100, 2000, 0, 0))
        agg.ingest(freshness_frame("h1", 25.0, 400, 2000, 0, 0))
        agg.ingest(freshness_frame("h0", 5.0, 100, 2010, 100, 1))
        agg.ingest(freshness_frame("h1", 25.0, 400, 2010, 300, 1))
        sk = agg.skew()
        assert sk["hosts"] == 2
        assert sk["freshness_lag_skew_ms"] == 20.0
        assert sk["hbm_imbalance_bytes"] == 300
        assert sk["per_host_hbm_bytes"] == {"h0": 100, "h1": 400}
        # one group summed across hosts: (100+300)/10s = 40/s, no divergence
        assert sk["per_group_rate"] == {"0": 40.0}
        c = agg.get_counters()
        assert c["freshness_lag_skew_ms"] == 20.0
        assert c["hbm_imbalance_bytes"] == 300
        return sk, c, agg.hosts()

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# one queryable pane: store rows through the SQL and PromQL planes


def test_fleet_store_rows_query_with_host_labels():
    def run(pkg):
        if pkg is PORT:
            from deepflow_tpu_torch.querier.engine import QueryEngine
            from deepflow_tpu_torch.querier.promql import query_instant
            from deepflow_tpu_torch.storage.store import ColumnarStore
            kw = {"device": "cpu"}
        else:
            from deepflow_tpu.querier import QueryEngine
            from deepflow_tpu.querier.promql import query_instant
            from deepflow_tpu.storage.store import ColumnarStore
            kw = {}
        store = ColumnarStore("")
        agg = pkg.fleet.FleetAggregator(store=store, autoregister=False,
                                        clock=lambda: 1000.0)
        agg.ingest(_frame(pkg, "h0", "0", 1000, {"flow_in": 10}, [[1, 2]]))
        agg.ingest(_frame(pkg, "h1", "1", 1000, {"flow_in": 32}, [[1, 1]]))
        assert agg.counters["store_rows"] == 2
        # PromQL with a host label selector — the label plane is unchanged
        out = query_instant(store, 'tpu_mesh_swm_flow_in{host="h1"}', 1000,
                            db="deepflow_system", table="deepflow_system")
        assert [s["value"] for s in out] == [32.0]
        assert out[0]["labels"]["group"] == "1"
        both = query_instant(store, "tpu_mesh_swm_flow_in", 1000,
                             db="deepflow_system", table="deepflow_system")
        assert sorted(s["labels"]["host"] for s in both) == ["h0", "h1"]
        # SQL over the same table
        rows = QueryEngine(store, **kw).execute(
            "SELECT metric, value FROM deepflow_system.deepflow_system").to_dicts()
        assert sorted(float(x["value"]) for x in rows) == [10.0, 32.0]
        return ([(s["labels"], float(s["value"])) for s in out],
                sorted((s["labels"]["host"], float(s["value"])) for s in both),
                sorted((str(x["metric"]), float(x["value"])) for x in rows))

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# the wire across packages: exporter → sink → aggregator over real TCP


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_fleet_sink_delivers_across_packages(direction):
    """One package's FleetSink (exporter + HandoffSender) ticks into the
    other package's FleetAggregator listener; the merged counters and
    hists equal those of the same frames ingested by a same-package
    aggregator in process."""
    import time

    snd, rcv = (PORT, REF) if direction == "port_to_ref" else (REF, PORT)
    agg = rcv.fleet.FleetAggregator(expiry_s=3600.0, autoregister=False,
                                    clock=lambda: 1000.0).start()
    local = snd.fleet.FleetAggregator(expiry_s=3600.0, autoregister=False,
                                      clock=lambda: 1000.0)
    frames = []
    try:
        for host, flow_in in (("hA", 9), ("hB", 31)):
            col = snd.stats.StatsCollector()

            class C:
                def get_counters(self, _v=flow_in):
                    return {"flow_in": _v}

            c = C()
            col.register("tpu_mesh_swm", c, group="0")

            class Face:
                def hist_dump(self, _v=flow_in):
                    return {"1s.e2e": [[1, _v], [4, 2]]}

            exp = snd.fleet.FleetExporter(host, group="0", collector=col,
                                          hist_faces={"g0": Face()}, clock=lambda: 1000.0)
            sink = snd.fleet.FleetSink(agg.endpoint(), exp)
            try:
                col.add_sink(sink)
                col.tick(1000.0)
                assert sink.flush(10)
                frames.append(exp.build(points=[p for p in col.sample(1000.0)
                                                if p.module == "tpu_mesh_swm"]))
            finally:
                sink.close()
        deadline = time.time() + 10
        while agg.counters["frames_rx"] < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert agg.counters["frames_rx"] == 2 and agg.counters["decode_errors"] == 0
        for f in frames:
            local.ingest(f)
        mine = {k: v for k, v in agg.merged_counters().items()
                if k.startswith("tpu_mesh_swm")}
        assert mine == {k: v for k, v in local.merged_counters().items()
                        if k.startswith("tpu_mesh_swm")}
        assert mine == {"tpu_mesh_swm{group=0}.flow_in": 40}
        assert agg.merged_hists() == local.merged_hists() \
            == {"g0.1s.e2e": [[1, 40], [4, 4]]}
        assert sorted(r["host"] for r in agg.hosts()) == ["hA", "hB"]
    finally:
        agg.stop()
