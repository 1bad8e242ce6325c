"""The trace reduction on a synthetic timeline: busy time is the union
of device work inside the window, card-side mirrors of host ranges are
no work, and an idle gap is named by the innermost host range open at
its middle."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import trace as T


def _evt(name, start, end, card=False, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name="CUDA" if card else "CPU"),
                           is_user_annotation=annotation)


def test_busy_idle_and_gaps():
    events = [
        _evt(T.WINDOW_RANGE, 0, 1000),
        _evt(T.WINDOW_RANGE, 0, 1000, card=True, annotation=True),
        _evt("bench.stage", 0, 400),
        _evt("aten::copy_", 100, 200),
        _evt("bench.ingest_staged", 400, 1000),
        _evt("Memcpy HtoD (Pageable -> Device)", 150, 300, card=True),
        _evt("segreduce_span_kernel<true, 8>", 520, 600, card=True),
        _evt("sketch_fused_kernel", 550, 700, card=True),
        _evt("segreduce_span_kernel<true, 8>", 900, 950, card=True),
    ]
    s = T.summarize(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((150 + 180 + 50) * 1e-6)
    assert len(s.kernels) == 3  # the copy is no kernel launch
    assert s.kernel_busy_s == pytest.approx((180 + 50) * 1e-6)
    assert s.kernel_durations(["segreduce"]) == pytest.approx([80e-6, 50e-6])
    assert s.idle_gaps[0] == ["bench.ingest_staged", pytest.approx(220e-6)]
    assert s.idle_gaps[1] == ["bench.ingest_staged", pytest.approx(200e-6)]
    assert s.idle_gaps[2] == ["bench.stage", pytest.approx(150e-6)]
    assert [n for n, _ in s.device_ops[:2]] == ["Memcpy HtoD (Pageable -> Device)",
                                               "sketch_fused_kernel"]


def test_no_device_work_reads_nothing():
    assert T.summarize([_evt(T.WINDOW_RANGE, 0, 10), _evt("aten::add", 1, 2)]) is None
    assert T.summarize([_evt("segreduce", 1, 2, card=True)]) is None
