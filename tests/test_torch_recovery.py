"""Journaled kill-and-recover on the port (feeder/runtime.py, feeder/
journal.py, chaos/, aggregator/checkpoint.py), against the reference's
tests/test_recovery.py and tests/test_chaos.py.

On the port alone (CPU):

  * the journal, flowframe and chaos copies: torn tail, reopen, rotate,
    bound, injected I/O faults, the (epoch, offset) barrier, replay from
    the runtime's own journal path (tests/test_recovery.py:331-490);
  * the single-chip kill matrix of tests/test_recovery.py:289 — a
    KillPoint at dispatch 2 (pre_advance), fetch 5 (mid_flush), dispatch
    3 (during_ckpt) and dispatch 4 (post_ckpt) — plus the crash between
    save and rotate (:303) and a kill before any checkpoint (:319): each
    recovered from checkpoint + journal bit-exact against the port's
    uninterrupted run, outputs and counters; each kill lands at the step
    the reference's does;
  * transient dispatch/fetch faults retry to identical output and count
    in `dispatch_retries` / `fetch_retries`; a lost device degrades the
    feeder and a probe recovers it; poisoned frames are quarantined; a
    checkpoint whose barrier flush fails aborts (tests/test_chaos.py).

Against the reference (one reference run of the schedule, cached): the
port's uninterrupted output stream, counters, seam call sequence,
journal bytes and final checkpoint equal the reference's, and the port
recovers from the reference's checkpoint and journal.

An autouse fixture uninstalls the chaos plan after every test; no test
starts a thread while a plan is installed.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu.aggregator import checkpoint as ref_ckpt
from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu import feeder as ref_feeder
from deepflow_tpu.ingest import queues as ref_queues
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.aggregator import checkpoint as ckpt
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu_torch.feeder import (
    FeederConfig,
    FeederRuntime,
    FrameJournal,
    PipelineFeedSink,
    decode_flowframe_body,
    encode_flowbatch_frames,
    read_journal,
)
from deepflow_tpu_torch.feeder.journal import REC_FRAME, REC_MARK
from deepflow_tpu_torch.ingest.framing import HEADER_LEN, split_message_spans
from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.utils.retry import RetryPolicy

torch.set_num_threads(1)

T0 = 1_700_000_000
BUCKETS = (64, 128, 256)
FAST_RETRY = RetryPolicy(attempts=4, base_delay_s=0.0, max_delay_s=0.0)

# tests/test_recovery.py:44: two checkpoint barriers, window advances at
# known dispatch indices, a multi-window flush, final drain
STEPS = (
    ("batch", T0, 100),
    ("batch", T0 + 1, 120),
    ("ckpt",),
    ("batch", T0 + 5, 90),
    ("batch", T0 + 6, 110),
    ("ckpt",),
    ("batch", T0 + 7, 80),
    ("batch", T0 + 10, 100),
    ("drain",),
)
LAST_CKPT = 5  # STEPS index of the second barrier


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    chaos.uninstall()
    ref_chaos.uninstall()


_FRAMES = None


def _frame_stream():
    """Every batch step's frames, encoded once (SyntheticFlowGen(150,
    seed=31), 64 rows a frame): oracle and victim see the same bytes."""
    global _FRAMES
    if _FRAMES is None:
        gen = SyntheticFlowGen(num_tuples=150, seed=31)
        _FRAMES = {i: encode_flowbatch_frames(gen.flow_batch(n, t), max_rows_per_frame=64)
                   for i, (kind, *args) in enumerate(STEPS) if kind == "batch"
                   for t, n in (args,)}
    return _FRAMES


@dataclasses.dataclass
class _Ctx:
    pipe: object
    q: object
    feeder: object
    ckpt: object  # checkpoint path
    save_fn: object  # the package's save_window_state
    load: object  # path → WindowManager

    def save(self, barrier):
        in_flight = self.save_fn(self.pipe.wm, self.ckpt, extra_meta=barrier)
        return [self.pipe._to_docbatch(f) for f in in_flight]

    def restore(self):
        self.pipe.wm = self.load(self.ckpt)

    def counters(self):
        c = self.pipe.get_counters()
        return {k: c[k] for k in ("doc_in", "flushed_doc", "drop_before_window",
                                  "prereduce_shed", "excess_word_hits", "stash_evictions",
                                  "window_advances", "feeder_shed")}


def _port_ctx(tmp, jname):
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12, delay=2),
                                     batch_size=256, bucket_sizes=BUCKETS), device="cpu")
    q = PyOverwriteQueue(1 << 12)
    feeder = FeederRuntime([q], PipelineFeedSink(pipe), FeederConfig(frames_per_queue=128),
                           journal=FrameJournal(tmp / jname))
    return _Ctx(pipe, q, feeder, tmp / "wm.ckpt", ckpt.save_window_state,
                lambda p: ckpt.load_window_state(p, TAG_SCHEMA, FLOW_METER, device="cpu"))


def _ref_ctx(tmp, jname):
    from deepflow_tpu.datamodel import schema as ref_schema

    pipe = ref_pipeline.L4Pipeline(ref_pipeline.PipelineConfig(
        window=ref_window.WindowConfig(capacity=1 << 12, delay=2), batch_size=256,
        bucket_sizes=BUCKETS))
    q = ref_queues.PyOverwriteQueue(1 << 12)
    feeder = ref_feeder.FeederRuntime(
        [q], ref_feeder.PipelineFeedSink(pipe), ref_feeder.FeederConfig(frames_per_queue=128),
        journal=ref_feeder.FrameJournal(tmp / jname))
    return _Ctx(pipe, q, feeder, tmp / "wm.ckpt", ref_ckpt.save_window_state,
                lambda p: ref_ckpt.load_window_state(p, ref_schema.TAG_SCHEMA,
                                                     ref_schema.FLOW_METER))


def _step(ctx, i, frames, outputs):
    """Run STEPS[i]; → True when it was a durable barrier (ckpt/drain)."""
    kind = STEPS[i][0]
    if kind == "batch":
        for fr in frames[i]:
            ctx.q.put(fr)
        outputs += ctx.feeder.pump()
        return False
    if kind == "ckpt":
        outputs += ctx.feeder.checkpoint(ctx.save)
        return True
    outputs += ctx.feeder.flush()
    outputs += ctx.pipe.drain()
    return True


def _execute(ctx, frames, start=0):
    """Run STEPS[start:] → (outputs, the output count after each step)."""
    outputs, marks = [], []
    for i in range(start, len(STEPS)):
        _step(ctx, i, frames, outputs)
        marks.append(len(outputs))
    return outputs, marks


class _SeamLog:
    """A rule-less plan that records the order in which this thread's
    seams fire (tests/conftest.py may run reference pipelines in a
    background thread meanwhile: their seams are not the schedule's)."""

    def __init__(self, plan_cls):
        self.plan = plan_cls()
        self.seq = []
        fire, tid = self.plan.fire, threading.get_ident()

        def logged(site):
            if threading.get_ident() == tid:
                self.seq.append(site)
            fire(site)

        self.plan.fire = logged


_ORACLE: dict = {}


def _port_oracle(tmp_path_factory):
    """The port's uninterrupted run (journal on — the same code path),
    with its seam sequence; cached: every kill variant compares to it."""
    if not _ORACLE:
        d = tmp_path_factory.mktemp("port_oracle")
        octx = _port_ctx(d, "j.bin")
        log = _SeamLog(chaos.FaultPlan)
        with chaos.active(log.plan):
            out, marks = _execute(octx, _frame_stream())
        _ORACLE.update(out=out, marks=marks, counters=octx.counters(), seq=log.seq, dir=d)
    return _ORACLE


def _assert_outputs_bit_exact(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        assert a.meters.tobytes() == b.meters.tobytes()  # f32 bit-exact


def _kill_and_recover(tmp_path, tmp_path_factory, rule, *, break_rotate=False):
    """Kill a victim by `rule`, recover on a fresh stack from checkpoint +
    journal only, finish the schedule: outputs and counters must equal
    the uninterrupted run's. Returns (recovered ctx, the killed step)."""
    oracle = _port_oracle(tmp_path_factory)
    frames = _frame_stream()
    vdir = tmp_path / "victim"
    vdir.mkdir()
    vctx = _port_ctx(vdir, "j1.bin")
    if break_rotate:
        # a crash between snapshot save and journal rotate: recovery must
        # rely on the (epoch, offset) barrier in the checkpoint meta
        vctx.feeder._journal.rotate = lambda: False
    outputs, durable, killed_at = [], 0, None
    with chaos.active(chaos.FaultPlan().add(rule)):
        for i in range(len(STEPS)):
            try:
                if _step(vctx, i, frames, outputs):
                    durable = len(outputs)
            except chaos.KillPoint:
                killed_at = i
                break
    assert killed_at is not None, "the kill-point never fired"
    survivors = outputs[:durable]  # post-barrier outputs die with the process

    rctx = _port_ctx(vdir, "j2.bin")
    barrier = None
    if vctx.ckpt.exists():
        meta = ckpt.read_checkpoint_meta(vctx.ckpt)
        if "journal_epoch" in meta:
            barrier = {k: meta[k] for k in ("journal_epoch", "journal_offset")}
        rctx.restore()
    recovered = rctx.feeder.replay_journal(vdir / "j1.bin", barrier=barrier)
    recovered += rctx.feeder.pump()  # completes the interrupted pump's tail
    rest, _ = _execute(rctx, frames, start=killed_at + 1)
    _assert_outputs_bit_exact(survivors + recovered + rest, oracle["out"])
    assert rctx.counters() == oracle["counters"]
    return rctx, killed_at


# the seams and indices of tests/test_recovery.py:275, with the STEPS index
# each lands on (double-buffered sink: dispatch i is the batch staged one
# step earlier; the T0+5 batch's advance is dispatch 2, its row fetch 5)
KILLS = {
    "pre_advance": (chaos.SITE_DISPATCH, 2, 4),
    "mid_flush": (chaos.SITE_FETCH, 5, 4),
    "during_ckpt": (chaos.SITE_DISPATCH, 3, 5),
    "post_ckpt": (chaos.SITE_DISPATCH, 4, 7),
}


@pytest.mark.parametrize("kill", list(KILLS))
def test_kill_and_recover_bit_exact(tmp_path, tmp_path_factory, kill):
    site, index, step = KILLS[kill]
    _, killed_at = _kill_and_recover(tmp_path, tmp_path_factory, chaos.FaultRule(
        site, at=(index,), error=chaos.KillPoint()))
    assert killed_at == step


def test_kill_between_save_and_rotate_does_not_double_apply(tmp_path, tmp_path_factory):
    """tests/test_recovery.py:303: snapshot saved, journal NOT rotated;
    replay must skip the pre-barrier frames via the checkpoint's
    (epoch, offset) barrier, or every checkpointed row counts twice."""
    rctx, _ = _kill_and_recover(
        tmp_path, tmp_path_factory,
        chaos.FaultRule(chaos.SITE_DISPATCH, at=(4,), error=chaos.KillPoint()),
        break_rotate=True)
    assert rctx.feeder.get_counters()["replayed_frames"] > 0


def test_recovery_without_any_checkpoint(tmp_path, tmp_path_factory):
    """tests/test_recovery.py:319: a kill before the first checkpoint is a
    full journal replay into an empty manager."""
    _kill_and_recover(tmp_path, tmp_path_factory, chaos.FaultRule(
        chaos.SITE_DISPATCH, at=(0,), error=chaos.KillPoint()))


# ---------------------------------------------------------------------------
# against the reference

_REF: dict = {}


def _ref_run(tmp_path_factory):
    """The reference's uninterrupted run of STEPS (once per module), with
    its seam sequence, its journal and its last checkpoint on disk."""
    if not _REF:
        d = tmp_path_factory.mktemp("ref")
        gen = RefFlowGen(num_tuples=150, seed=31)
        frames = {i: ref_feeder.encode_flowbatch_frames(gen.flow_batch(n, t),
                                                        max_rows_per_frame=64)
                  for i, (kind, *args) in enumerate(STEPS) if kind == "batch"
                  for t, n in (args,)}
        ctx = _ref_ctx(d, "j.bin")
        log = _SeamLog(ref_chaos.FaultPlan)
        ref_chaos.install(log.plan)
        try:
            out, marks = _execute(ctx, frames)
        finally:
            ref_chaos.uninstall()
        ctx.feeder._journal.close()
        _REF.update(out=out, marks=marks, counters=ctx.counters(), seq=log.seq, dir=d,
                    frames=frames)
    return _REF


def test_port_schedule_equals_reference(tmp_path_factory):
    """The uninterrupted schedule: the port's output stream, counters and
    the order in which dispatch / fetch / decode / journal / checkpoint
    seams fire equal the reference's; the wire frames, the journal file
    and the last checkpoint are byte-identical."""
    ref = _ref_run(tmp_path_factory)
    port = _port_oracle(tmp_path_factory)
    assert [f for f in _frame_stream().values()] == list(ref["frames"].values())
    _assert_outputs_bit_exact(port["out"], ref["out"])
    assert port["marks"] == ref["marks"]
    assert port["counters"] == ref["counters"]
    assert port["seq"] == ref["seq"]
    assert port["seq"].count(chaos.SITE_DISPATCH) == 6
    assert (port["dir"] / "j.bin").read_bytes() == (ref["dir"] / "j.bin").read_bytes()
    p_meta, p_arrays = ckpt._read_checkpoint(port["dir"] / "wm.ckpt")
    r_meta, r_arrays = ref_ckpt._read_checkpoint(ref["dir"] / "wm.ckpt")
    assert p_meta == r_meta and p_meta["journal_epoch"] == 1
    assert sorted(p_arrays) == sorted(r_arrays)
    assert all(p_arrays[k].tobytes() == r_arrays[k].tobytes() for k in r_arrays)


def test_port_recovers_from_reference_checkpoint_and_journal(tmp_path, tmp_path_factory):
    """A port worker takes over from a JAX one: the reference's last
    checkpoint + its journal (frames since that barrier) replayed through
    the port's feeder give the reference's outputs after the barrier."""
    ref = _ref_run(tmp_path_factory)
    rctx = _port_ctx(tmp_path, "j2.bin")
    rctx.pipe.wm = ckpt.load_window_state(ref["dir"] / "wm.ckpt", TAG_SCHEMA, FLOW_METER,
                                          device="cpu")
    meta = ckpt.read_checkpoint_meta(ref["dir"] / "wm.ckpt")
    got = rctx.feeder.replay_journal(ref["dir"] / "j.bin", barrier={
        k: meta[k] for k in ("journal_epoch", "journal_offset")})
    got += rctx.feeder.pump()
    got += rctx.feeder.flush()
    got += rctx.pipe.drain()
    assert rctx.feeder.get_counters()["replayed_frames"] == sum(
        len(ref["frames"][i]) for i in (6, 7))
    _assert_outputs_bit_exact(got, ref["out"][ref["marks"][LAST_CKPT]:])
    assert rctx.counters() == ref["counters"]


# ---------------------------------------------------------------------------
# journal file format (tests/test_recovery.py:331-490)


def test_journal_roundtrip_and_torn_tail(tmp_path):
    p = tmp_path / "j.bin"
    j = FrameJournal(p)
    j.append(b"frame-one")
    j.append(b"frame-two")
    j.mark()
    j.append(b"frame-three")
    j.mark()
    j.close()
    epoch, entries, truncated = read_journal(p)
    assert epoch == 0 and not truncated
    assert [(k, pl) for k, pl, _ in entries] == [
        (REC_FRAME, b"frame-one"), (REC_FRAME, b"frame-two"), (REC_MARK, b""),
        (REC_FRAME, b"frame-three"), (REC_MARK, b""),
    ]
    # the reference reads the port's file record for record
    assert ref_feeder.read_journal(p) == (epoch, entries, truncated)
    data = p.read_bytes()
    p.write_bytes(data[:-20])  # cut into frame-three's record
    _, entries, truncated = read_journal(p)
    assert truncated
    assert [pl for k, pl, _ in entries if k == REC_FRAME] == [b"frame-one", b"frame-two"]
    buf = bytearray(data)
    buf[len(data) // 2] ^= 0xFF  # corrupt interior record: replay stops at it
    p.write_bytes(bytes(buf))
    _, entries2, truncated2 = read_journal(p)
    assert truncated2 and len(entries2) < 5


def test_journal_reopen_truncates_torn_tail(tmp_path):
    p = tmp_path / "j.bin"
    j = FrameJournal(p)
    j.append(b"pre-crash")
    j.mark()
    j.close()
    p.write_bytes(p.read_bytes()[:-5])  # tear into the trailing MARK
    j2 = FrameJournal(p)
    assert j2.get_counters()["reopen_truncations"] == 1
    j2.append(b"post-restart")
    j2.mark()
    j2.close()
    _, entries, truncated = read_journal(p)
    assert not truncated
    assert [pl for k, pl, _ in entries if k == REC_FRAME] == [b"pre-crash", b"post-restart"]


def test_journal_rotate_bound_and_io_faults(tmp_path):
    """rotate bumps the epoch and clears (a reopen resumes it); past
    max_bytes appends are dropped and counted; an injected journal I/O
    fault is contained and counted."""
    p = tmp_path / "j.bin"
    j = FrameJournal(p)
    j.append(b"old")
    j.mark()
    epoch, off = j.sync_offset()
    assert epoch == 0 and off > 0 and j.rotate()
    j.append(b"new")
    j.mark()
    j.close()
    epoch, entries, truncated = read_journal(p)
    assert epoch == 1 and not truncated and j.get_counters()["rotations"] == 1
    assert [pl for k, pl, _ in entries if k == REC_FRAME] == [b"new"]
    assert FrameJournal(p).epoch == 1

    jb = FrameJournal(tmp_path / "b.bin", max_bytes=256)
    appended = sum(1 for _ in range(20) if jb.append(b"x" * 64))
    jb.close()
    c = jb.get_counters()
    assert appended < 20 and c["overflow_frames"] == 20 - appended and c["frames"] == appended

    jf = FrameJournal(tmp_path / "f.bin")
    with chaos.active(chaos.FaultPlan().add(chaos.FaultRule(
            chaos.SITE_JOURNAL_IO, at=(1,), error=chaos.CheckpointIOError))):
        assert jf.append(b"ok") and not jf.append(b"lost") and jf.append(b"ok2")
    jf.mark()
    jf.close()
    assert jf.get_counters()["io_errors"] == 1
    _, entries, _ = read_journal(tmp_path / "f.bin")
    assert [pl for k, pl, _ in entries if k == REC_FRAME] == [b"ok", b"ok2"]


def test_replay_respects_barrier_and_own_path(tmp_path):
    """Frames before the checkpoint's (epoch, offset) never reach the
    decode path; replaying the runtime's own journal path rotates it
    first, so each frame is journaled once (tests/test_recovery.py:442,
    :466)."""
    frames = _frame_stream()
    p = tmp_path / "j.bin"
    j = FrameJournal(p)
    for fr in frames[0]:
        j.append(fr)
    j.mark()
    epoch, off = j.sync_offset()
    for fr in frames[1]:
        j.append(fr)
    j.mark()
    j.close()
    ctx = _port_ctx(tmp_path, "j2.bin")
    ctx.feeder.replay_journal(p, barrier={"journal_epoch": epoch, "journal_offset": off})
    c = ctx.feeder.get_counters()
    assert c["replayed_frames"] == len(frames[1]) and c["records_in"] == 120

    ctx2 = _port_ctx(tmp_path, "j.bin")  # the SAME path it replays
    ctx2.feeder.replay_journal(p)
    n = ctx2.feeder.get_counters()["replayed_frames"]
    assert n == len(frames[0]) + len(frames[1])
    ctx2.feeder._journal.close()
    epoch, entries, truncated = read_journal(p)
    assert epoch == 1 and not truncated
    payloads = [pl for k, pl, _ in entries if k == REC_FRAME]
    assert len(payloads) == n == len(set(payloads))


def test_flowframe_bytes_equal_the_reference(tmp_path):
    """The port's frames are the reference's bytes (one seeded batch,
    every chunking), decode back to the batch's valid rows, and peek their
    row counts from the header."""
    fb = SyntheticFlowGen(num_tuples=30, seed=5).flow_batch(150, T0)
    ref_fb = RefFlowGen(num_tuples=30, seed=5).flow_batch(150, T0)
    for rows in (16, 64, 2048):
        frames = encode_flowbatch_frames(fb, max_rows_per_frame=rows)
        assert frames == ref_feeder.encode_flowbatch_frames(ref_fb, max_rows_per_frame=rows)
    body = frames[0][HEADER_LEN:]
    (o, ln), = split_message_spans(body)
    got = decode_flowframe_body(body[o:o + ln])
    keep = fb.valid
    np.testing.assert_array_equal(got.meters, fb.meters[keep])
    for k, v in got.tags.items():
        np.testing.assert_array_equal(v, fb.tags[k][keep])
    sink = PipelineFeedSink(L4Pipeline(PipelineConfig(bucket_sizes=BUCKETS), device="cpu"))
    assert sink.count_records(frames[0]) == int(keep.sum())


# ---------------------------------------------------------------------------
# fault containment (tests/test_chaos.py)


def _mk_feeder(**fkw):
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=256,
                                     bucket_sizes=BUCKETS), device="cpu")
    pipe.wm.retry_policy = FAST_RETRY
    q = PyOverwriteQueue(1 << 10)
    return pipe, q, FeederRuntime([q], PipelineFeedSink(pipe),
                                  FeederConfig(frames_per_queue=64, **fkw))


def _deliver(q, fb, max_rows=64):
    for fr in encode_flowbatch_frames(fb, max_rows_per_frame=max_rows):
        q.put(fr)


def test_transient_faults_retry_to_identical_output():
    """tests/test_chaos.py:176: injected transient dispatch and fetch
    faults retry (counted) to the fault-free output; a lost device is not
    retried."""

    def run(plan):
        gen = SyntheticFlowGen(num_tuples=120, seed=21)
        pipe = _mk_feeder()[0]
        out = []
        with chaos.active(plan or chaos.FaultPlan()):
            for t in (T0, T0 + 1, T0 + 5, T0 + 6):
                out += pipe.ingest(gen.flow_batch(200, t))
            out += pipe.drain()
        return out, pipe.get_counters()

    oracle, oc = run(None)
    plan = chaos.FaultPlan().add(
        chaos.FaultRule(chaos.SITE_DISPATCH, at=(1, 2), error=chaos.TransientDeviceError),
        chaos.FaultRule(chaos.SITE_FETCH, at=(3,), error=chaos.FetchTimeout))
    faulted, fc = run(plan)
    assert plan.injected == {chaos.SITE_DISPATCH: 2, chaos.SITE_FETCH: 1}
    assert (fc["dispatch_retries"], fc["fetch_retries"]) == (2, 1)
    assert (oc["dispatch_retries"], oc["fetch_retries"]) == (0, 0)
    _assert_outputs_bit_exact(faulted, oracle)
    pipe = _mk_feeder()[0]
    with chaos.active(chaos.FaultPlan().add(
            chaos.FaultRule(chaos.SITE_DISPATCH, at=(0,), error=chaos.DeviceLost))):
        with pytest.raises(chaos.DeviceLost):
            pipe.ingest(SyntheticFlowGen(num_tuples=10, seed=1).flow_batch(20, T0))
    assert pipe.get_counters()["dispatch_retries"] == 0


def test_lost_device_degrades_and_probe_recovers():
    """tests/test_chaos.py:214: every dispatch failing turns the feeder
    degraded (frames shed whole and counted, no exception); once the
    device is back a probe pump recovers it; records are conserved."""
    _, q, feeder = _mk_feeder(probe_interval=3)
    gen = SyntheticFlowGen(num_tuples=100, seed=5)
    _deliver(q, gen.flow_batch(100, T0))
    feeder.pump()
    assert feeder.get_counters()["healthy"] == 1
    with chaos.active(chaos.FaultPlan().add(
            chaos.FaultRule(chaos.SITE_DISPATCH, count=10 ** 9, error=chaos.DeviceLost))):
        _deliver(q, gen.flow_batch(100, T0 + 1))
        feeder.pump()
        c = feeder.get_counters()
        assert c["degraded"] == 1 and c["emit_failures"] >= 1 and c["degraded_entries"] == 1
        for i in range(2):
            _deliver(q, gen.flow_batch(50, T0 + 2 + i))
            feeder.pump()
        assert feeder.get_counters()["degraded_shed_records"] > 0
    for i in range(4):
        _deliver(q, gen.flow_batch(50, T0 + 5 + i))
        feeder.pump()
        if not feeder.get_counters()["degraded"]:
            break
    feeder.flush()
    c = feeder.get_counters()
    assert c["degraded_exits"] == 1 and c["healthy"] == 1 and c["probe_attempts"] >= 1
    assert c["records_in"] == c["records_out"] + c["pending_rows"]
    assert c["lost_records"] > 0 and c["shed_records"] >= c["degraded_shed_records"] > 0


def test_poisoned_frames_quarantine_and_barrier_abort(tmp_path):
    """tests/test_chaos.py:359 and :610: corrupt frames are quarantined and
    counted while good frames flow; a checkpoint whose barrier flush fails
    writes no snapshot and keeps the journal un-rotated."""
    pipe, q, feeder = _mk_feeder()
    rng = random.Random(0xBAD)
    frames = encode_flowbatch_frames(SyntheticFlowGen(num_tuples=60, seed=13)
                                     .flow_batch(120, T0), max_rows_per_frame=32)
    for i, fr in enumerate(frames):
        q.put(fr if i % 3 == 0 else chaos.bitflip_frame(fr, rng, flips=8) if i % 3 == 1
              else chaos.truncate_frame(fr, rng))
    feeder.pump()
    c, sink = feeder.get_counters(), feeder.sink
    assert 0 < sink.decode_errors == c["bad_frames"] <= 2 * len(frames) // 3
    assert len(sink.quarantine) == min(sink.decode_errors, 8)
    assert c["records_in"] > 0 and c["healthy"] == 1

    fj = FeederRuntime([q], PipelineFeedSink(pipe), FeederConfig(frames_per_queue=64),
                       journal=FrameJournal(tmp_path / "j.bin"))
    _deliver(q, SyntheticFlowGen(num_tuples=60, seed=37).flow_batch(80, T0 + 1))
    fj.pump()  # stages the batch (double buffer)
    saves = []
    with chaos.active(chaos.FaultPlan().add(
            chaos.FaultRule(chaos.SITE_DISPATCH, count=10 ** 9, error=chaos.DeviceLost))):
        fj.checkpoint(lambda barrier: saves.append(barrier) or [])
    c = fj.get_counters()
    assert c["checkpoint_aborts"] == 1 and c["last_checkpoint_ok"] == 0 and not saves
    assert fj._journal.epoch == 0


def test_quiesce_snapshot_schedule_and_spans(tmp_path):
    """quiesce drains the queue over several pumps, then runs the
    checkpoint barrier (journal rotated); snapshot_interval_pumps=1
    refreshes the open-window snapshot after every pump; the tracer holds
    the feeder's stages; a backlog that does not shrink aborts the
    handover with the drained outputs attached."""
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12,
                                                         min_snapshot_interval=0.0),
                                     batch_size=256, bucket_sizes=BUCKETS), device="cpu")
    q = PyOverwriteQueue(1 << 10)
    feeder = FeederRuntime([q], PipelineFeedSink(pipe),
                           FeederConfig(frames_per_queue=4, rounds_per_pump=1,
                                        snapshot_interval_pumps=1),
                           journal=FrameJournal(tmp_path / "j.bin"))
    _deliver(q, SyntheticFlowGen(num_tuples=60, seed=9).flow_batch(200, T0), max_rows=16)
    saves = []
    feeder.quiesce(lambda barrier: saves.append(barrier) or [])
    c = feeder.get_counters()
    assert len(q) == 0 and c["pending_rows"] == 0 and c["records_in"] == 200
    assert [sorted(b) for b in saves] == [["journal_epoch", "journal_offset"]]
    assert feeder._journal.epoch == 1 and c["last_checkpoint_ok"] == 1
    assert c["snapshots_taken"] >= 4 and feeder.last_snapshot.windows
    spans = feeder.tracer.summary()
    assert spans["feeder.drain"]["count"] >= 4 and spans["feeder.dispatch"]["count"] >= 4

    class Unfenced(PyOverwriteQueue):
        def __len__(self):  # a producer keeps the backlog up
            return 1

    stuck = FeederRuntime([Unfenced(8)], PipelineFeedSink(pipe), FeederConfig())
    with pytest.raises(chaos.RebalanceAbortError, match="did not shrink") as e:
        stuck.quiesce(lambda barrier: [])
    assert e.value.outputs == []


def test_pressure_shedding_is_counted_into_the_counter_block():
    """A queue above its high watermark admits only the newest frames;
    the shed ones are counted from their headers and reach the counter
    block's feeder_shed lane with the next dispatched batch; records in =
    records out + pending."""
    pipe, q, feeder = _mk_feeder()
    q = PyOverwriteQueue(8)
    feeder = FeederRuntime([q], PipelineFeedSink(pipe), FeederConfig(frames_per_queue=2))
    _deliver(q, SyntheticFlowGen(num_tuples=40, seed=4).flow_batch(128, T0), max_rows=16)
    # depth 8 ≥ 6: each round drains 4 frames, admits the newest 2 and
    # sheds 2; at depth 4 > 2 the second round is still under pressure
    feeder.pump()
    c = feeder.get_counters()
    assert (c["pressure_events"], c["shed_frames"], c["shed_records"]) == (1, 4, 64)
    assert len(q) == 0 and pipe.get_counters()["feeder_shed"] == 0
    feeder.flush()  # the held batch carries the shed count to the device
    c = feeder.get_counters()
    assert c["records_in"] == 64 == c["records_out"] + c["pending_rows"]
    assert pipe.get_counters()["feeder_shed"] == 64


def test_serve_delivers_flushed_windows_to_on_flush():
    """serve() pumps in its own thread and hands every flushed window to
    on_flush; stop() joins it."""
    pipe, q, feeder = _mk_feeder()
    got = []
    feeder.serve(poll_ms=1, on_flush=got.extend)
    try:
        # however the pumps split them, 700 rows make ≥ 3 emits of ≤ 256:
        # the second dispatch (T0+5 rows) closes window T0
        gen = SyntheticFlowGen(num_tuples=60, seed=6)
        _deliver(q, gen.flow_batch(100, T0), max_rows=16)
        _deliver(q, gen.flow_batch(600, T0 + 5), max_rows=16)
        deadline = time.monotonic() + 60
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        feeder.stop()
    assert feeder._thread is None and got
    assert all(int(db.timestamp[0]) < T0 + 3 for db in got)
    assert feeder.get_counters()["pump_errors"] == 0
