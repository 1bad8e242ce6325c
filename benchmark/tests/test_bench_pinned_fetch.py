"""The reader of the drain's page-locked landings (`pinned_fetch_pct`):
the window delta of span `flush.copy`'s `pinned` count over its count,
and nothing where the program reports no such count."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import harness as H
from benchmark.metrics import pinned_fetch_pct

from .conftest import ROOT, tiny_spec


def _run_of(before: dict, after: dict):
    return SimpleNamespace(ctx=H.Context(spec=None, device="cpu", spans_before=before,
                                         spans_after=after))


def test_the_share_of_the_window_s_row_fetches():
    before = {"flush.copy": {"count": 2, "total_us": 10, "bytes": 8, "pinned": 2}}
    after = {"flush.copy": {"count": 6, "total_us": 30, "bytes": 24, "pinned": 5}}
    assert pinned_fetch_pct.read(_run_of(before, after)) == pytest.approx(75.0)
    # no drain before the window opened
    assert pinned_fetch_pct.read(_run_of({}, after)) == pytest.approx(100.0 * 5 / 6)


def test_nothing_from_a_program_without_the_count():
    older = {"flush.copy": {"count": 9, "total_us": 900, "bytes": 90}}
    assert pinned_fetch_pct.read(_run_of(older, older)) is None
    assert pinned_fetch_pct.read(_run_of({}, {})) is None


def test_declared_for_every_cell_beside_the_row_fetch():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    m = per_layer["pinned_fetch_pct"]
    assert m["layer"] == per_layer["drain_copy_gbps"]["layer"]
    assert m["moves"] == "close_ms_p80" and m["source"] == "program_span"
    assert m["workloads"] == [w["name"] for w in bench["workloads"]]


def test_a_tiny_traced_run_on_the_cpu_leaves_it_out():
    res = H.run_cell(tiny_spec("exact.hicard"), 2**31 + 29, 0.3, True, "cpu")
    assert res["correct"] is True, res["checks"]
    assert "pinned_fetch_pct" not in res["metrics"]
    assert res["metrics"]["drain_copy_gbps"]["value"] > 0
