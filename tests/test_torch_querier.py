"""The port's SQL engine (querier/) against the reference's, on the CPU:
one corpus of statements over one store, drawn from tests/test_querier.py
and tests/test_querier_functions.py — Sum, Max, Min, Avg, AAvg, Count,
Uniq, Percentile, Spread, Rspread, Stddev, Apdex, Percentage, TopK, Any,
Last, PerSecond, Derivative, interval(time, N), name() translation (a
flow_tag dictionary and an enum), IN / NOT, HAVING on an aggregate and
on an alias, derived metrics, Counter_Avg, SELECT *, SHOW and tier
routing over a bare family name.

Results are equal: integer-valued floats below 2^24 bit for bit, other
floats within rtol 1e-5, everything else exactly. The reference's
aggregates are float32 (JAX runs with 64-bit types off), so values past
2^24 round; the port reduces in float32 the same way, and a probe table
of such values pins it: Min(16777217, …) is 16777216 on both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepflow_tpu.querier import QueryEngine as RefQueryEngine
from deepflow_tpu.storage.store import ColumnarStore as RefStore
from deepflow_tpu_torch.querier import QueryEngine
from deepflow_tpu_torch.querier.sqlparse import SQLError
from deepflow_tpu_torch.storage.store import ColumnarStore, ColumnSpec, TableSchema

CPU = torch.device("cpu")
T0 = 1_700_000_000 - (1_700_000_000 % 3600)
BIG = 2 ** 24


def _tables():
    """(db, schema, columns) of every table in the store."""
    rng = np.random.default_rng(0)
    n = 1000
    app = TableSchema("application_1s", tuple(ColumnSpec(c, t) for c, t in (
        ("time", "u4"), ("auto_service_id_0", "u4"), ("tap_side", "u4"),
        ("app_service", "U64"), ("request", "f4"), ("response", "f4"),
        ("client_error", "f4"), ("server_error", "f4"), ("rrt_sum", "f4"),
        ("rrt_count", "f4"), ("rrt_max", "f4"), ("timeout", "f4"),
        ("direction_score", "f4"))))
    app_cols = {
        "time": (T0 + rng.integers(0, 120, n)).astype(np.uint32),
        "auto_service_id_0": rng.integers(1, 5, n).astype(np.uint32),
        "tap_side": rng.choice([1, 2], n).astype(np.uint32),
        "app_service": np.array([f"svc-{i}" for i in rng.integers(0, 4, n)]),
        "request": np.ones(n, np.float32),
        "response": np.ones(n, np.float32),
        "client_error": (rng.random(n) < 0.1).astype(np.float32),
        "server_error": (rng.random(n) < 0.05).astype(np.float32),
        "rrt_sum": rng.integers(100, 10_000, n).astype(np.float32),
        "rrt_count": np.ones(n, np.float32),
        "rrt_max": rng.integers(100, 10_000, n).astype(np.float32),
        "timeout": np.zeros(n, np.float32),
        "direction_score": np.zeros(n, np.float32),
    }
    svc_map = TableSchema("auto_service_map", (ColumnSpec("time", "u4"), ColumnSpec("id", "u4"),
                                               ColumnSpec("name", "U64")))
    svc_cols = {"time": np.zeros(4, np.uint32), "id": np.arange(1, 5, dtype=np.uint32),
                "name": np.array([f"payments-{i}" for i in range(1, 5)])}
    log = TableSchema("l4_flow_log", tuple(ColumnSpec(c, t) for c, t in (
        ("time", "u4"), ("tap_side", "u4"), ("server_port", "u4"), ("byte_tx", "f4"),
        ("byte_rx", "f4"), ("packet_tx", "f4"), ("packet_rx", "f4"), ("rtt", "f4"))))
    log_cols = {
        "time": np.array([T0, T0, T0, T0 + 60, T0 + 60, T0 + 60], np.uint32),
        "tap_side": np.array([1, 2, 1, 2, 1, 2], np.uint32),
        "server_port": np.array([80, 80, 443, 443, 80, 80], np.uint32),
        "byte_tx": np.array([10, 20, 30, 40, 50, 60], np.float32),
        "byte_rx": np.array([1, 2, 3, 4, 5, 6], np.float32),
        "packet_tx": np.ones(6, np.float32),
        "packet_rx": np.full(6, 2, np.float32),
        "rtt": np.array([0, 100, 200, 0, 300, 400], np.float32),
    }
    out = [("flow_metrics", app, app_cols), ("flow_tag", svc_map, svc_cols),
           ("flow_log", log, log_cols)]
    # the network family at three granularities, for tier routing and
    # the time-axis wrappers
    for suffix, step, rows in (("1s", 1, 600), ("1m", 60, 40), ("1h", 3600, 4)):
        schema = TableSchema(f"network_{suffix}", tuple(ColumnSpec(c, t) for c, t in (
            ("time", "u4"), ("tap_side", "u4"), ("byte_tx", "f4"), ("byte_rx", "f4"),
            ("rtt_sum", "f4"), ("rtt_count", "f4"), ("rtt_max", "f4"))),
            partition_s=max(3600, step))
        out.append(("flow_metrics", schema, {
            "time": (T0 + step * rng.integers(0, rows, rows)).astype(np.uint32),
            "tap_side": rng.choice([1, 2], rows).astype(np.uint32),
            "byte_tx": rng.integers(0, 5000, rows).astype(np.float32),
            "byte_rx": rng.integers(0, 500, rows).astype(np.float32),
            "rtt_sum": rng.integers(0, 9000, rows).astype(np.float32),
            "rtt_count": rng.integers(0, 10, rows).astype(np.float32),
            "rtt_max": rng.integers(0, 900, rows).astype(np.float32),
        }))
    # values past 2^24, where float32 rounds
    probe = TableSchema("big_values", (ColumnSpec("time", "u4"), ColumnSpec("k", "u4"),
                                       ColumnSpec("big", "u4"), ColumnSpec("huge", "i8")))
    out.append(("probe", probe, {
        "time": np.full(8, T0, np.uint32),
        "k": np.array([0, 0, 0, 1, 1, 1, 2, 2], np.uint32),
        "big": np.array([BIG + 1, BIG + 2, BIG + 3, BIG + 5, BIG + 7, 3, 1, 2], np.uint32),
        "huge": np.array([2 ** 40 + 1, 2 ** 40 + 3, 7, 2 ** 41 + 1, 5, 9, 2 ** 33 + 1, 1],
                         np.int64),
    }))
    return out


CORPUS = (
    "SELECT app_service, Sum(request) AS req, Avg(rrt_sum) AS a, Max(rrt_max) AS mx, "
    "Min(rrt_max) AS mn, Count() AS c, Uniq(auto_service_id_0) AS u "
    "FROM application.1s GROUP BY app_service ORDER BY app_service",
    "SELECT app_service, rrt_avg, error_ratio FROM application.1s "
    "GROUP BY app_service ORDER BY app_service",
    "SELECT interval(time, 60) AS t, Sum(request) AS req FROM application.1s "
    "GROUP BY interval(time, 60) ORDER BY t",
    "SELECT name(auto_service_id_0) AS svc, Sum(request) AS req FROM application.1s "
    "GROUP BY name(auto_service_id_0) ORDER BY svc",
    "SELECT name(tap_side) AS side, Count() AS c FROM application.1s "
    "GROUP BY name(tap_side) ORDER BY side",
    "SELECT app_service, Sum(request) AS req FROM application.1s "
    "WHERE app_service IN ('svc-0', 'svc-1') GROUP BY app_service ORDER BY req DESC LIMIT 1",
    f"SELECT time, request FROM application.1s WHERE time >= {T0 + 10} AND time < {T0 + 20} "
    "ORDER BY time",
    "SELECT app_service, Percentile(rrt_sum, 50) AS p50, Percentile(rrt_sum, 95) AS p95 "
    "FROM application.1s GROUP BY app_service ORDER BY app_service",
    "SELECT Count() AS c FROM application.1s WHERE NOT tap_side = 1",
    f"SELECT * FROM application.1s WHERE time >= {T0 + 100} ORDER BY time, rrt_sum",
    "SELECT app_service, tap_side, Max(rrt_max) AS m, Count() AS c FROM application.1s "
    "GROUP BY app_service, tap_side HAVING Count() > 100 ORDER BY m DESC",
    "select server_port, Sum(byte_tx) as b from l4_flow_log group by server_port "
    "having Sum(byte_tx) > 100 order by b desc",
    "select server_port, Count(1) as cnt from l4_flow_log group by server_port "
    "having cnt > 2 order by cnt desc",
    "select Max(rtt) as mx, Min(rtt) as mn, Avg(rtt) as a, AAvg(byte_tx) as aa, "
    "Spread(byte_tx) as sp, Rspread(rtt) as rs, Stddev(byte_tx) as sd, Sum(byte) as b "
    "from l4_flow_log",
    "select Apdex(rtt, 150) as v, Percentage(byte_rx, byte_tx) as p, "
    "TopK(server_port, 1) as tk, Any(server_port) as a, Last(byte_tx) as lst, "
    "Histogram(byte_tx, 2) as h from l4_flow_log",
    f"select Avg(byte_tx) as v from l4_flow_log where time >= {T0} and time < {T0 + 120}",
    "select interval(time, 60) as t, PerSecond(Sum(byte_tx)) as v, "
    "Derivative(Sum(byte_tx)) as d from network.1s group by t order by t",
    "select interval(time, 60) as t, tap_side, Sum(byte_tx) as b, Max(rtt_max) as m "
    "from network group by t, tap_side order by t, tap_side",
    "select interval(time, 3600) as t, Sum(byte_tx) as b, Avg(rtt_max) as a "
    "from network group by t order by t",
    "select Sum(byte_tx) as b, Count() as c from network",
    "select k, Min(big) as mn, Max(big) as mx, Sum(big) as s, Avg(big) as a, "
    "Sum(huge) as sh, Max(huge) as mh, Any(big) as an from probe.big_values "
    "group by k order by k",
    "SHOW tables",
)


def _fill(store):
    for db, schema, cols in _tables():
        store.create_table(db, schema)
        store.insert(db, schema.name, cols)
    return store


@pytest.fixture(scope="module")
def engines():
    return (QueryEngine(_fill(ColumnarStore()), cache=False, device=CPU),
            RefQueryEngine(_fill(RefStore()), cache=False))


def _assert_results_equal(got, want):
    assert got.columns == want.columns
    assert got.rows == want.rows
    for c in want.columns:
        g, w = np.asarray(got.values[c]), np.asarray(want.values[c])
        assert g.dtype == w.dtype, c
        if w.dtype.kind == "f":
            exact = np.all(np.abs(w) < BIG) & np.all(w == np.round(w))
            if exact:
                assert np.array_equal(g, w), c
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=c)
        else:
            assert np.array_equal(g, w), c


@pytest.mark.parametrize("sql", CORPUS, ids=range(len(CORPUS)))
def test_corpus_matches_reference(engines, sql):
    port, ref = engines
    _assert_results_equal(port.execute(sql), ref.execute(sql))


def test_tier_routing_matches_reference(engines):
    port, ref = engines
    for sql, table in (
        ("select interval(time, 60) as t, Sum(byte_tx) as b from network group by t", "network_1m"),
        ("select interval(time, 7200) as t, Sum(byte_tx) as b from network group by t",
         "network_1h"),
        ("select interval(time, 30) as t, Sum(byte_tx) as b from network group by t", "network_1s"),
        ("select Sum(byte_tx) as b from network", "network_1s"),
    ):
        assert port.resolve_query_table(sql) == ref.resolve_query_table(sql) == (
            "flow_metrics", table)


def test_float32_aggregates_as_the_reference(engines):
    """JAX with 64-bit types off rounds the reference's aggregates to
    float32; the port matches it, values and dtype."""
    port, ref = engines
    sql = ("select k, Min(big) as mn, Max(big) as mx, Sum(big) as s from probe.big_values "
           "group by k order by k")
    got, want = port.execute(sql), ref.execute(sql)
    for c in ("mn", "mx", "s"):
        assert got.values[c].dtype == want.values[c].dtype == np.float32
        assert np.array_equal(got.values[c], want.values[c])
    assert got.values["mn"][0] == BIG  # 2^24 + 1 rounds down to 2^24
    assert got.values["mx"][0] == BIG + 4  # 2^24 + 3 rounds up to 2^24 + 4


def test_errors_match_reference(engines):
    port, ref = engines
    for sql in ("SELECT nope FROM application.1s", "SELECT request FROM no_such_table",
                "SELECT app_service, Sum(request) FROM application.1s GROUP BY time",
                "select interval(PerSecond(byte_tx), 60) from l4_flow_log"):
        with pytest.raises(SQLError):
            port.execute(sql)
        with pytest.raises(Exception, match=".") as info:
            ref.execute(sql)
        assert type(info.value).__name__ == "SQLError"


def test_result_cache_serves_repeats():
    from deepflow_tpu_torch.querier.live import QueryResultCache

    cache = QueryResultCache(max_entries=4)
    store = _fill(ColumnarStore())
    eng = QueryEngine(store, cache=cache, device=CPU)
    a = eng.execute(CORPUS[0])
    b = eng.execute(CORPUS[0])
    assert b is a and cache.get_counters()["hits"] == 1
    store.insert("flow_metrics", "application_1s", {k: v[:1] for k, v in _tables()[0][2].items()})
    c = eng.execute(CORPUS[0])
    assert c is not a and cache.get_counters()["invalidations"] == 1


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(ColumnarStore())
