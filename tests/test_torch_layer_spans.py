"""The rollup's layer spans (utils/spans ROLLUP_SPAN_NAMES) on a tiny L4
pipeline: profiler ranges nested inside their parents, nothing opened
without a profiler, the work counts against the transfer counters, no
device time on the CPU, and outputs and fetches unchanged with the
spans in place. The device-time event pairs run against fake events
here, and against the card in the `cuda` test at the end:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_spans.py

This file imports neither JAX nor the JAX package."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepflow_tpu_torch.aggregator import window as window_mod
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.utils import spans
from deepflow_tpu_torch.utils.spans import (
    MAX_PENDING_PAIRS,
    ROLLUP_SPAN_NAMES,
    SPAN_FLUSH_COPY,
    SPAN_FLUSH_DRAIN,
    SPAN_FLUSH_SPLIT,
    SPAN_FLUSH_WAIT,
    SPAN_INGEST_DISPATCH,
    SPAN_STAGE_PACK,
    SPAN_STAGE_UPLOAD,
    SPAN_STEP_FANOUT,
    SPAN_STEP_PREREDUCE,
    SPAN_STEP_SKETCH,
    SPAN_WINDOW_ADVANCE,
    SPAN_WINDOW_FOLD,
    SpanTracer,
    SpanWork,
)

T0 = 1_700_000_000
BATCHES = 6
FETCHES = [1, 2, 2, 3, 3, 3]  # host fetches of each call of _run
STAGE_RANGE = "test.stage"
_SK = dict(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256, topk_rows=2,
           topk_cols=64, pending=8)

# child range → the range it runs inside
PARENT = {
    SPAN_STAGE_PACK: STAGE_RANGE,
    SPAN_STAGE_UPLOAD: STAGE_RANGE,
    SPAN_STEP_PREREDUCE: SPAN_INGEST_DISPATCH,
    SPAN_STEP_SKETCH: SPAN_INGEST_DISPATCH,
    SPAN_STEP_FANOUT: SPAN_INGEST_DISPATCH,
    SPAN_WINDOW_FOLD: SPAN_WINDOW_ADVANCE,
    SPAN_FLUSH_WAIT: SPAN_FLUSH_DRAIN,
    SPAN_FLUSH_COPY: SPAN_FLUSH_DRAIN,
    SPAN_FLUSH_SPLIT: SPAN_FLUSH_DRAIN,
}


def _pipe(sketch: bool, device="cpu"):
    cfg = SketchConfig(hist=LogHistSpec(bins=32, vmin=1.0, gamma=1.3), **_SK) if sketch else None
    return L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12, sketch=cfg),
                                     batch_size=256, batch_unique_cap=256), device=device)


def _run(pipe, batches=BATCHES):
    """Stage + ingest_staged a replay, one event second a batch (windows
    close from the fourth on); returns the closed DocBatches and the
    host fetches of each call."""
    gen = SyntheticFlowGen(num_tuples=200, seed=3)
    out, fetches = [], []
    for i in range(batches):
        f0 = pipe.wm.host_fetches
        with torch.profiler.record_function(STAGE_RANGE):
            staged = pipe.stage(gen.flow_batch(128, T0 + i))
        out += pipe.ingest_staged(staged)
        fetches.append(pipe.wm.host_fetches - f0)
    return out, fetches


def _ranges(events) -> dict[str, list[tuple[float, float]]]:
    out: dict[str, list] = {}
    for e in events:
        if e.name in PARENT or e.name in PARENT.values():
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "sketch"])
def test_layer_ranges_sit_inside_their_parents_under_the_profiler(sketch):
    pipe = _pipe(sketch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(pipe)
    got = _ranges(prof.events())
    want = set(ROLLUP_SPAN_NAMES) | {SPAN_WINDOW_FOLD}
    if not sketch:
        want.discard(SPAN_STEP_SKETCH)
    assert want <= set(got), sorted(got)
    assert (SPAN_STEP_SKETCH in got) == sketch
    for child in want:
        parents = got[PARENT[child]]
        for s, e in got[child]:
            assert any(ps <= s and e <= pe for ps, pe in parents), (child, s, e)
    # the two stage spans cover stage() one after the other
    for (ps, pe), (us, ue) in zip(got[SPAN_STAGE_PACK], got[SPAN_STAGE_UPLOAD]):
        assert pe <= us
    assert len(got[SPAN_STAGE_PACK]) == len(got[SPAN_STAGE_UPLOAD]) == BATCHES
    # host spans and profiler ranges count the same calls
    summary = pipe.tracer.summary()
    for name in want:
        assert summary[name]["count"] == len(got[name]), name


def test_no_profiler_range_opens_without_a_profiler(monkeypatch):
    calls = []
    real = spans.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    pipe = _pipe(sketch=True)
    _run(pipe, batches=4)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        _run(pipe, batches=1)
    assert SPAN_STEP_FANOUT in calls and SPAN_STAGE_UPLOAD in calls


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "sketch"])
def test_span_bytes_equal_the_transfer_counters(monkeypatch, sketch):
    """stage.upload's bytes are bytes_uploaded; flush.copy's are the row
    fetches' share of bytes_fetched (the int32 row transfers; counter
    blocks and scalars are int64)."""
    row_bytes = []
    fetch = window_mod.host_fetch

    def recording(x):
        arr = fetch(x)
        if x.dtype == torch.int32:
            row_bytes.append(arr.nbytes)
        return arr

    monkeypatch.setattr(window_mod, "host_fetch", recording)
    pipe = _pipe(sketch)
    _run(pipe)
    s = pipe.tracer.summary()
    assert s[SPAN_STAGE_UPLOAD]["bytes"] == pipe.get_counters()["bytes_uploaded"] > 0
    assert s[SPAN_FLUSH_COPY]["bytes"] == sum(row_bytes) > 0
    assert s[SPAN_FLUSH_COPY]["count"] == len(row_bytes)
    others = {k: v for k, v in s.items() if k not in (SPAN_STAGE_UPLOAD, SPAN_FLUSH_COPY)}
    assert not any("bytes" in v for v in others.values())
    c = pipe.tracer.get_counters()
    assert c[f"{SPAN_FLUSH_COPY}.bytes"] == sum(row_bytes)


def _no_spans(self, name, device=None):
    @contextlib.contextmanager
    def cm():
        yield SpanWork()

    return cm()


def _docs(out):
    return [(db.timestamp.copy(), db.tags.copy(), db.meters.copy()) for db in out]


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "sketch"])
def test_outputs_and_fetches_are_unchanged_by_the_spans(monkeypatch, sketch):
    plain = _pipe(sketch)
    with profile(activities=[ProfilerActivity.CPU]):
        out_p, fetch_p = _run(plain)
    for agg in plain.tracer.summary().values():  # a CPU device: no device time, no zeros
        assert "device_us" not in agg and "device_count" not in agg
    assert not any(k.endswith((".device_us", ".device_count"))
                   for k in plain.tracer.get_counters())
    monkeypatch.setattr(SpanTracer, "span", _no_spans)
    bare = _pipe(sketch)
    out_b, fetch_b = _run(bare)
    assert len(out_p) == len(out_b) >= 3
    for (ts_p, tags_p, m_p), (ts_b, tags_b, m_b) in zip(_docs(out_p), _docs(out_b)):
        np.testing.assert_array_equal(ts_p, ts_b)
        np.testing.assert_array_equal(tags_p, tags_b)
        np.testing.assert_array_equal(m_p.view(np.uint32), m_b.view(np.uint32))
    if sketch:
        blocks_p, blocks_b = plain.pop_closed_sketches(), bare.pop_closed_sketches()
        assert len(blocks_p) == len(blocks_b) > 0
        for a, b in zip(blocks_p, blocks_b):
            np.testing.assert_array_equal(a.hll, b.hll)
            np.testing.assert_array_equal(a.cms, b.cms)
    # one counter-block fetch a call; an advance adds the scalar fetch,
    # and the row fetch once rows close
    assert fetch_p == fetch_b == FETCHES
    assert plain.wm.bytes_fetched == bare.wm.bytes_fetched
    assert plain.wm.bytes_uploaded == bare.wm.bytes_uploaded


class _FakeEvent:
    """A timing event on a fake stream: `record` stamps the stream's
    clock, `query` is true once the test finishes it."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None
        self.done = False

    def record(self, stream=None):
        _FakeEvent.clock += 1.5
        self.t, self.done = _FakeEvent.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t  # ms


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")

    def no_sync(*a, **k):
        raise AssertionError("the tracer must never synchronise")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    return torch.device("cuda", 0)


def test_device_pairs_resolve_in_order_once_finished(fake_cuda):
    tr = SpanTracer()
    evs = []
    for _ in range(2):
        with tr.span(SPAN_STEP_FANOUT, fake_cuda):
            pass
        evs.append(list(tr._pending)[-1][2:])
    with tr.span(SPAN_STAGE_PACK):  # no device: no pair
        pass
    assert _FakeEvent.made == 4 and len(tr._pending) == 2
    assert tr.resolve_device() == 0
    assert "device_us" not in tr.summary()[SPAN_STEP_FANOUT]
    # the second pair finished alone: the walk stops at the first
    for ev in evs[1]:
        ev.done = True
    assert tr.resolve_device() == 0
    for ev in evs[0]:
        ev.done = True
    assert tr.resolve_device() == 2
    s = tr.summary()[SPAN_STEP_FANOUT]
    assert s["device_count"] == 2 and s["device_us"] == pytest.approx(2 * 1.5e3)
    assert "device_us" not in tr.summary()[SPAN_STAGE_PACK]
    c = tr.get_counters()
    assert c[f"{SPAN_STEP_FANOUT}.device_count"] == 2
    # finished events go back to the pool: the next span makes none
    with tr.span(SPAN_WINDOW_FOLD, fake_cuda):
        pass
    assert _FakeEvent.made == 4


def test_unread_device_pairs_stay_bounded(fake_cuda):
    tr = SpanTracer()
    for _ in range(MAX_PENDING_PAIRS + 10):
        with tr.span(SPAN_WINDOW_FOLD, fake_cuda):
            pass
    assert len(tr._pending) == MAX_PENDING_PAIRS
    for _, _, a, b in tr._pending:
        a.done = b.done = True
    assert tr.resolve_device() == MAX_PENDING_PAIRS
    assert tr.summary()[SPAN_WINDOW_FOLD]["device_count"] == MAX_PENDING_PAIRS
    assert tr.summary()[SPAN_WINDOW_FOLD]["count"] == MAX_PENDING_PAIRS + 10


def test_device_pairs_are_read_outside_the_spans_that_time_the_fetches():
    """resolve_device() runs after stats.fetch and flush.drain close, so
    fetch_wait_ms and the drain metrics hold no tracer bookkeeping."""
    pipe = _pipe(sketch=True)
    tr = pipe.tracer
    open_spans, seen = [], []
    span = tr.span

    @contextlib.contextmanager
    def tracked(name, device=None):
        open_spans.append(name)
        try:
            with span(name, device) as work:
                yield work
        finally:
            open_spans.pop()

    tr.span = tracked
    tr.resolve_device = lambda: seen.append(tuple(open_spans)) or 0
    _run(pipe)
    # one read after every counter-block fetch, one after every drain
    assert len(seen) == BATCHES + tr.summary()[SPAN_FLUSH_DRAIN]["count"]
    assert all(stack == () for stack in seen), seen


def test_chip_smoke_counts_no_span_mirror_as_card_work():
    """chip_smoke's profiler readers count kernels, copies and memsets;
    the card-side mirror of a span's profiler range is no work."""
    from types import SimpleNamespace

    import chip_smoke

    cuda_t, cpu_t = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, dev=cuda_t, **kw):
        return SimpleNamespace(key=key, device_type=dev, **kw)

    work = [ev("segreduce_gather_kernel", is_user_annotation=False),
            ev("Memcpy DtoH (Device -> Pageable)", is_user_annotation=False)]
    events = work + [
        ev(SPAN_STEP_FANOUT, is_user_annotation=True),
        ev(SPAN_FLUSH_DRAIN),  # a profiler build that leaves the flag out
        ev("aten::add", cpu_t, is_user_annotation=False),
    ]
    assert chip_smoke._card_work(SimpleNamespace(key_averages=lambda: events)) == work


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device time comes from CUDA events")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_device_time_on_the_card_is_read_at_the_existing_fetches(cuda, monkeypatch):
    synced = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: synced.append(1))
    pipe = _pipe(sketch=True, device=cuda)
    _, fetches = _run(pipe)
    assert synced == []
    s = pipe.tracer.summary()
    for name in (SPAN_STEP_PREREDUCE, SPAN_STEP_SKETCH, SPAN_STEP_FANOUT):
        # every step's pair was read at its counter-block fetch
        assert s[name]["device_count"] == BATCHES and s[name]["device_us"] > 0, name
    assert s[SPAN_WINDOW_FOLD]["device_count"] == s[SPAN_WINDOW_FOLD]["count"]
    assert not any("device_us" in s[n] for n in (SPAN_STAGE_PACK, SPAN_FLUSH_SPLIT))
    assert fetches == FETCHES
    real_sync()
