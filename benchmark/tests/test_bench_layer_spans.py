"""The readers of the program's layer spans: window deltas of the span
summaries, None where the program reports nothing (an older program
without the span, or device time on the CPU), and a tiny traced run on
the CPU that reads every host-side one."""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest

from benchmark import harness as H
from benchmark.span_delta import delta, device_ms, gbps

from .conftest import ROOT, tiny_spec

NEW = ("pack_ms", "upload_gbps", "prereduce_device_ms", "sketch_device_ms",
       "fanout_device_ms", "fold_device_ms", "drain_wait_ms", "drain_copy_gbps",
       "drain_split_ms")
HOST = ("pack_ms", "upload_gbps", "drain_wait_ms", "drain_copy_gbps", "drain_split_ms")


def _run_of(before: dict, after: dict):
    return SimpleNamespace(ctx=H.Context(spec=None, device="cpu", spans_before=before,
                                         spans_after=after))


def test_window_deltas():
    before = {"step.fanout": {"count": 2, "total_us": 10, "device_us": 100.0,
                              "device_count": 2},
              "flush.copy": {"count": 1, "total_us": 1000, "bytes": 4_000_000}}
    after = {"step.fanout": {"count": 6, "total_us": 30, "device_us": 900.0,
                             "device_count": 6},
             "flush.copy": {"count": 3, "total_us": 3000, "bytes": 12_000_000},
             "window.fold": {"count": 4, "total_us": 50}}
    ctx = _run_of(before, after).ctx
    assert delta(ctx, "step.fanout", "device_count") == 4
    assert device_ms(ctx, "step.fanout") == pytest.approx(0.2)
    assert gbps(ctx, "flush.copy") == pytest.approx(4.0)
    # window.fold without device time (a CPU run), a span never opened
    assert device_ms(ctx, "window.fold") is None
    assert device_ms(ctx, "step.prereduce") is None and gbps(ctx, "stage.upload") is None


def test_readers_read_nothing_from_a_program_without_the_spans():
    older = {"ingest.dispatch": {"count": 9, "total_us": 900},
             "window.fold": {"count": 9, "total_us": 90},
             "flush.drain": {"count": 9, "total_us": 9000}}
    run = _run_of(older, older)
    for name in NEW:
        assert importlib.import_module(f"benchmark.metrics.{name}").read(run) is None, name


def test_each_new_metric_is_declared_with_its_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and set(m["workloads"]) <= set(cells)
    assert per_layer["sketch_device_ms"]["workloads"] == ["sketch.hicard"]


@pytest.mark.parametrize("workload", ["exact.hicard", "sketch.hicard"])
def test_a_tiny_traced_run_reads_the_host_side_layers(workload):
    res = H.run_cell(tiny_spec(workload), 2**31 + 11, 0.3, True, "cpu")
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    for name in HOST:
        assert got[name]["value"] > 0, name
    # a CPU run has no device time: the device readers leave their metric out
    assert not {"prereduce_device_ms", "sketch_device_ms", "fanout_device_ms",
                "fold_device_ms"} & set(got)
