"""The port's trace plane (deepflow_tpu_torch/tracing/{tree,builder,query})
against the JAX package's on the same spans: assembled trees are
`encode()`-equal, builder rows and query results equal, and the pure id
functions (`search_index`, `window_trace_id`, `hop_span_id`) agree on
seeded strings. The cases are those of tests/test_tracing.py that need
no collector."""

from __future__ import annotations

import numpy as np
import pytest

import deepflow_tpu.flowlog.aggr as ref_aggr
import deepflow_tpu.flowlog.schema as ref_schema
import deepflow_tpu.flowlog.server as ref_server
import deepflow_tpu.storage.store as ref_store
import deepflow_tpu.storage.writer as ref_writer
import deepflow_tpu.tracing as ref_tracing
import deepflow_tpu.tracing.lineage as ref_lineage
import deepflow_tpu.tracing.query as ref_query
import deepflow_tpu_torch.flowlog.aggr as port_aggr
import deepflow_tpu_torch.flowlog.schema as port_schema
import deepflow_tpu_torch.flowlog.server as port_server
import deepflow_tpu_torch.storage.store as port_store
import deepflow_tpu_torch.storage.writer as port_writer
import deepflow_tpu_torch.tracing as port_tracing
import deepflow_tpu_torch.tracing.lineage as port_lineage
import deepflow_tpu_torch.tracing.query as port_query

T0 = 1_700_000_000

REF = dict(tracing=ref_tracing, query=ref_query, store=ref_store, writer=ref_writer,
           aggr=ref_aggr, schema=ref_schema, server=ref_server)
PORT = dict(tracing=port_tracing, query=port_query, store=port_store, writer=port_writer,
            aggr=port_aggr, schema=port_schema, server=port_server)


def _span(pkg, tid, sid, psid, svc, dur=1000, err=False):
    return pkg["tracing"].SpanRow(
        trace_id=tid, span_id=sid, parent_span_id=psid, app_service=svc,
        start_us=T0 * 1_000_000, end_us=T0 * 1_000_000 + dur,
        response_duration_us=dur, server_error=err,
    )


# each case: a list of span specs (tid, sid, psid, svc, dur, err)
ASSEMBLY_CASES = {
    "linear_chain": [("t1", "a", "", "frontend", 1000, False),
                     ("t1", "b", "a", "cart", 500, False),
                     ("t1", "c", "b", "db", 200, True)],
    "merges_same_service": [("t2", "a", "", "api", 1000, False),
                            ("t2", "b", "a", "db", 100, False),
                            ("t2", "c", "a", "db", 300, False)],
    "orphan_pseudo_link": [("t3", "a", "", "frontend", 1000, False),
                           ("t3", "z", "missing-parent", "batch", 1000, False)],
    "encode_roundtrip": [("t4", "a", "", "svc-a", 1000, False),
                         ("t4", "b", "a", "svc-b", 1000, True)],
    "cycle_is_cut": [("t5", "a", "b", "svc-a", 1000, False),
                     ("t5", "b", "a", "svc-b", 1000, False)],
}


@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_assembled_trees_encode_equal(case):
    trees = []
    for pkg in (REF, PORT):
        spans = [_span(pkg, *s) for s in ASSEMBLY_CASES[case]]
        tree = pkg["tracing"].assemble_trace(spans)
        back = pkg["tracing"].TraceTree.decode(tree.time, tree.trace_id, tree.encode())
        assert back.to_dict() == tree.to_dict()
        trees.append(tree)
    ref, port = trees
    assert port.encode() == ref.encode()
    assert port.to_dict() == ref.to_dict()
    assert port.search_index == ref.search_index


def test_pure_ids_equal_on_seeded_strings():
    rng = np.random.default_rng(12)
    alphabet = np.array(list("abcdef0123456789-_.:/"))
    for _ in range(200):
        s = "".join(rng.choice(alphabet, int(rng.integers(0, 40))))
        assert port_tracing.search_index(s) == ref_tracing.search_index(s)
        svc = "".join(rng.choice(alphabet, int(rng.integers(1, 20))))
        w, iv = int(rng.integers(0, 2**40)), int(rng.choice([1, 60, 3600]))
        tid = port_lineage.window_trace_id(svc, w, iv)
        assert tid == ref_lineage.window_trace_id(svc, w, iv)
        for hop in (port_lineage.HOP_FLUSH_DRAIN, port_lineage.HOP_INGEST_DISPATCH, s):
            assert port_lineage.hop_span_id(tid, hop) == ref_lineage.hop_span_id(tid, hop)


def _builder_run(pkg, spans_specs, **kw):
    store = pkg["store"].ColumnarStore()
    b = pkg["tracing"].TraceTreeBuilder(store, writer_args={"flush_interval_s": 0.01}, **kw)
    for group in spans_specs:
        b.observe([_span(pkg, *s) for s in group])
    closed = b.tick()
    b.flush()
    rows = store.scan("flow_log", "trace_tree")
    counters = b.get_counters()
    b.stop()
    return store, closed, rows, counters


def _rows_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


BIG = [("big", "root", "", "gateway", 1000, False)] + [
    ("big", f"s{i}", "root", f"service-with-a-rather-long-name-{i:04d}", 1000, False)
    for i in range(200)]

BUILDER_CASES = {
    "closes_quiet_traces": ([[("trace-x", "a", "", "frontend", 1000, False),
                              ("trace-x", "b", "a", "db", 1000, False)]],
                            dict(close_after_s=0.0), "trace-x"),
    "evicts_oldest": ([[("t-1", "a", "", "s1", 1000, False)],
                       [("t-2", "a", "", "s2", 1000, False)],
                       [("t-3", "a", "", "s3", 1000, False)]],
                      dict(close_after_s=999, max_traces=2), "t-1"),
    "sheds_oversized_tree": ([BIG], dict(close_after_s=0.0), "big"),
}


@pytest.mark.parametrize("case", sorted(BUILDER_CASES))
def test_builder_rows_and_query_equal(case):
    specs, kw, tid = BUILDER_CASES[case]
    ref_s, ref_closed, ref_rows, ref_c = _builder_run(REF, specs, **kw)
    port_s, port_closed, port_rows, port_c = _builder_run(PORT, specs, **kw)
    assert port_closed == ref_closed
    _rows_equal(port_rows, ref_rows)
    assert port_c == ref_c
    got = port_query.query_trace(port_s, tid)
    assert got == ref_query.query_trace(ref_s, tid)
    assert got is not None
    assert port_query.trace_map(port_s) == ref_query.trace_map(ref_s)


def _open_spans_store(pkg, tid, spans):
    """Spans still open: l7_flow_log rows only (no trace_tree row yet)."""
    s = pkg["schema"].L7_FLOW_LOG
    n = len(spans)
    ints = np.zeros((n, len(s.ints)), np.uint32)
    nums = np.zeros((n, len(s.nums)), np.float32)
    strs = {f.name: [""] * n for f in s.strs}
    for r, (sid, psid, svc, dur) in enumerate(spans):
        ints[r, s.int_index("end_time")] = T0
        ints[r, s.int_index("start_time")] = T0
        ints[r, s.int_index("response_duration")] = dur
        strs["trace_id"][r] = tid
        strs["span_id"][r] = sid
        strs["parent_span_id"][r] = psid
        strs["app_service"][r] = svc
    store = pkg["store"].ColumnarStore()
    w = pkg["writer"].TableWriter(store, "flow_log", pkg["server"].log_table_schema(s),
                                  flush_interval_s=0.01)
    w.put(pkg["server"].log_batch_to_columns(
        pkg["aggr"].FlowLogBatch(s, ints, nums, np.ones(n, bool), strs)))
    w.flush()
    w.stop()
    return store


@pytest.mark.parametrize("face", ["query_trace", "tempo_trace"])
def test_open_span_reads_equal(face):
    spans = [("a", "", "web", 100), ("b", "a", "auth", 500), ("c", "b", "db", 70)]
    outs = []
    for pkg in (REF, PORT):
        store = _open_spans_store(pkg, "open-trace", spans)
        fn = getattr(pkg["query"], face)
        outs.append((fn(store, "open-trace"), fn(store, "nope")))
    assert outs[1] == outs[0]
    assert outs[1][0] is not None and outs[1][1] is None


def test_span_tracer_lineage_context_exports_as_the_reference():
    """A stage span recorded with a window's derived ids keeps them (and
    its window key in the endpoint) through export_otlp; a plain span
    keeps synthesized singleton ids — column for column as the
    reference's tracer exports them."""
    import deepflow_tpu.utils.spans as ref_spans
    import deepflow_tpu_torch.utils.spans as port_spans

    got = []
    for spans_mod, lin_mod in ((ref_spans, ref_lineage), (port_spans, port_lineage)):
        tr = spans_mod.SpanTracer(service="t")
        tid = lin_mod.window_trace_id("tpu.pipeline", T0, 1)
        tr.record("window.advance", 123, start_s=float(T0), trace_id=tid,
                  span_id=lin_mod.hop_span_id(tid, "window.advance"),
                  parent_span_id=lin_mod.hop_span_id(tid, "ingest.dispatch"),
                  window=f"{T0}@1s")
        tr.record("stats.fetch", 7, start_s=float(T0 + 1))
        cols = {}

        class _Exp:
            def export(self, table, c):
                cols[table] = c

        assert tr.export_otlp(_Exp()) == 2
        got.append(cols["l7_flow_log"])
    ref, port = got
    _rows_equal(port, ref)
    assert port["endpoint"][0] == f"window.advance:{T0}@1s"
    assert port["parent_span_id"][0] == port_lineage.hop_span_id(
        port["trace_id"][0], "ingest.dispatch") and port["parent_span_id"][1] == ""
