"""Port parity for the v6 window checkpoint (aggregator/checkpoint.py).

The same seeded stream goes through the reference `L4Pipeline` (JAX,
CPU backend) and the port's on the CPU:

  * both save at the same point: the two files hold the same array
    names, dtypes, shapes and bytes and the same meta, so the same
    sha256 digest — slab plane + cascade (full fold, per-batch fetch),
    pooled plane + K = 4 counter ring (merge fold), async drain;
  * cross-load both ways: the reference's file resumed in the port and
    the port's file resumed in the reference each continue the stream
    bit-exact against the reference's uninterrupted run (DocBatches,
    tier DocBatches, closed and tier sketch blocks, counters), and so
    does the port's own uninterrupted run;

and on the port alone (the reference's tests/test_checkpoint_misc.py:18,
:58 and tests/test_recovery.py:501, :527, :683, :780, :893, :1012):
resume preserves open windows and async in-flight windows; truncation,
a digest mismatch, v1 and kind mismatches fail loudly; the sketch plane
and the cascade tiers round-trip mid-window / mid-minute; pre-v4 and
pre-v5 files (built by dropping members from a port-saved file) and a
changed pool geometry re-initialize loudly; the load defaults to CUDA.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging

import numpy as np
import pytest
import torch

from deepflow_tpu.aggregator import checkpoint as ref_ckpt
from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.aggregator.cascade import CascadeConfig as RefCascadeConfig
from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.aggregator.sketchplane import SketchConfig as RefSketchConfig
from deepflow_tpu.datamodel import schema as ref_schema
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.aggregator import checkpoint as ckpt
from deepflow_tpu_torch.aggregator import pipeline
from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig, SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig, WindowManager
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.ops.u32 import from_numpy_u32
from tests.test_torch_sketch_plane import _assert_blocks_equal

torch.set_num_threads(1)

T0 = 1_700_000_040  # the first second of a minute
CAP = 1 << 12


def _sk(mod_sketch, mod_hist, pool=None):
    """tests/test_recovery.py's small sketch shape, in either package."""
    return mod_sketch(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256,
                      hist=mod_hist(bins=32, vmin=1.0, gamma=1.3), topk_rows=2,
                      topk_cols=64, pending=8, pool=pool)


def _pool(mod_pool):
    return mod_pool(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4,
                    hist_factor=8, promote_fill=0.05)


# (fold mode, sketch plane, cascade intervals, window extras): the three
# deferral regimes a save must settle
CASES = {
    "slab_cascade_full": ("full", "slab", (60, 3600), {}),
    "pool_ring_merge": ("merge", "pool", None, dict(stats_ring=4)),
    "async_full": ("full", None, None, dict(async_drain=True)),
}
# the save lands after T0+33: the open minute holds T0 … T0+30 with a
# partly merged parent block (T0+90 closes it), the K = 4 ring two
# undrained blocks, async the T0+33 block, whose advance flushes T0+30
SPANS = [T0, T0 + 19, T0 + 21, T0 + 19, T0 + 30, T0 + 33, T0 + 45, T0 + 90]
SAVE_AFTER = 5


def _configs(case):
    mode, plane, intervals, extra = CASES[case]
    r_sk = p_sk = None
    if plane:
        r_sk = _sk(RefSketchConfig, RefLogHistSpec,
                   _pool(RefPoolConfig) if plane == "pool" else None)
        p_sk = _sk(SketchConfig, LogHistSpec, _pool(PoolConfig) if plane == "pool" else None)
    r_casc = p_casc = None
    if intervals:
        r_casc = RefCascadeConfig(intervals=intervals, capacity=CAP)
        p_casc = CascadeConfig(intervals=intervals, capacity=CAP)
    ref = ref_pipeline.PipelineConfig(
        window=ref_window.WindowConfig(capacity=CAP, sketch=r_sk, fold_mode=mode,
                                       cascade=r_casc, **extra), batch_size=256)
    port = pipeline.PipelineConfig(
        window=WindowConfig(capacity=CAP, sketch=p_sk, fold_mode=mode, cascade=p_casc,
                            **extra), batch_size=256)
    return ref, port


def _batches():
    gen = RefFlowGen(num_tuples=50, seed=3)
    return [gen.flow_batch(100, t) for t in SPANS]


def _port_batch(fb) -> FlowBatch:
    return FlowBatch(tags=dict(fb.tags), meters=fb.meters, valid=fb.valid)


def _drive(pipe, batches, to_batch=lambda fb: fb) -> dict:
    """Ingest `batches`, then drain: the DocBatches, tier pairs, closed
    sketch blocks and tier sketch blocks they emit."""
    docs, tiers = [], []
    for fb in batches:
        docs += pipe.ingest(to_batch(fb))
        tiers += pipe.pop_tier_docbatches()
    docs += pipe.drain()
    tiers += pipe.pop_tier_docbatches()
    tier_blocks, pipe.closed_tier_sketches = pipe.closed_tier_sketches, []
    return {"docs": docs, "tiers": tiers, "blocks": pipe.pop_closed_sketches(),
            "tier_blocks": tier_blocks}


COUNTERS = ("doc_in", "flushed_doc", "drop_before_window", "prereduce_shed",
            "excess_word_hits", "window_advances", "feeder_shed", "sketch_rows",
            "sketch_shed", "cascade_rows", "cascade_shed", "cascade_tier_windows",
            "tier_windows_held", "tier_windows_dropped")


def _counters(pipe) -> dict:
    c = pipe.get_counters()
    return {k: c[k] for k in COUNTERS if k in c}


def _assert_docs_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))


def _assert_run_equal(want: dict, got: dict):
    _assert_docs_equal(want["docs"], got["docs"])
    assert [iv for iv, _ in want["tiers"]] == [iv for iv, _ in got["tiers"]]
    _assert_docs_equal([db for _, db in want["tiers"]], [db for _, db in got["tiers"]])
    for key in ("blocks", "tier_blocks"):
        assert len(want[key]) == len(got[key]), key
        for a, b in zip(want[key], got[key]):
            _assert_blocks_equal(a, b, key)


def _assert_flushed_equal(want, got):
    """In-flight FlushedWindows of the two saves, field for field."""
    assert [(f.window_idx, f.tier, f.interval, f.count) for f in want] == [
        (f.window_idx, f.tier, f.interval, f.count) for f in got]
    for a, b in zip(want, got):
        for lane in ("key_hi", "key_lo", "tags"):
            np.testing.assert_array_equal(np.asarray(getattr(a, lane)), getattr(b, lane))
        np.testing.assert_array_equal(np.asarray(a.meters).view(np.uint32),
                                      b.meters.view(np.uint32))
        _assert_blocks_equal(a.sketches, b.sketches, f"in-flight {a.window_idx}")


_RUNS: dict = {}


def _case_runs(case, tmp_path_factory):
    """The case's runs, once per module: the reference's uninterrupted run
    (saving at SAVE_AFTER), the port's, and a resume of each file in the
    other package."""
    if case in _RUNS:
        return _RUNS[case]
    d = tmp_path_factory.mktemp(case)
    r_cfg, p_cfg = _configs(case)
    batches = _batches()
    head, tail = batches[:SAVE_AFTER + 1], batches[SAVE_AFTER + 1:]

    ref = ref_pipeline.L4Pipeline(r_cfg)
    for fb in head:
        ref.ingest(fb)
        ref.pop_tier_docbatches()
    ref.pop_closed_sketches()
    ref.closed_tier_sketches = []
    r_flight = ref_ckpt.save_window_state(ref.wm, d / "ref.ckpt")
    oracle = _drive(ref, tail)
    oracle_c = _counters(ref)

    port = pipeline.L4Pipeline(p_cfg, device="cpu")
    for fb in head:
        port.ingest(_port_batch(fb))
        port.pop_tier_docbatches()
    port.pop_closed_sketches()
    port.closed_tier_sketches = []
    p_flight = ckpt.save_window_state(port.wm, d / "port.ckpt")
    port_run = _drive(port, tail, _port_batch)
    port_c = _counters(port)

    # the reference's file resumed in the port
    p_res = pipeline.L4Pipeline(p_cfg, device="cpu")
    p_res.wm = ckpt.load_window_state(d / "ref.ckpt", TAG_SCHEMA, FLOW_METER, device="cpu")
    port_from_ref = _drive(p_res, tail, _port_batch)
    # the port's file resumed in the reference
    r_res = ref_pipeline.L4Pipeline(r_cfg)
    r_res.wm = ref_ckpt.load_window_state(d / "port.ckpt", ref_schema.TAG_SCHEMA,
                                          ref_schema.FLOW_METER)
    ref_from_port = _drive(r_res, tail)
    _RUNS[case] = dict(dir=d, r_flight=r_flight, p_flight=p_flight, oracle=oracle,
                       oracle_c=oracle_c, port_run=port_run, port_run_c=port_c,
                       port_from_ref=port_from_ref, port_from_ref_c=_counters(p_res),
                       ref_from_port=ref_from_port, ref_from_port_c=_counters(r_res))
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_port_file_equals_reference_file(case, tmp_path_factory):
    """Same stream prefix, same save point: equal array names, dtypes,
    shapes and bytes, equal meta, equal digest — and the same windows in
    flight."""
    runs = _case_runs(case, tmp_path_factory)
    r_meta, r_arrays = ref_ckpt._read_checkpoint(runs["dir"] / "ref.ckpt")
    p_meta, p_arrays = ckpt._read_checkpoint(runs["dir"] / "port.ckpt")
    assert sorted(r_arrays) == sorted(p_arrays)
    for name, a in r_arrays.items():
        b = p_arrays[name]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name
    assert p_meta == r_meta
    assert p_meta["digest"] == ckpt._digest(p_arrays) == ref_ckpt._digest(r_arrays)
    # the plane's promote_fill is never written (the PoolConfig's is)
    assert p_meta["version"] == 6 and "sk_promote_fill" not in p_arrays
    assert not any("promote" in k for k in p_meta if k != "sketch_pool_promos")
    _assert_flushed_equal(runs["r_flight"], runs["p_flight"])
    if case == "slab_cascade_full":
        assert p_meta["cascade_pending"], "the save must hold a partly merged minute"
    if case == "async_full":
        assert runs["p_flight"], "the async save must hand back in-flight windows"


@pytest.mark.parametrize("case", list(CASES))
def test_cross_load_continues_bit_exact(case, tmp_path_factory):
    """Each file resumed in the other package, and the port's own run,
    continue the stream exactly as the reference's uninterrupted run."""
    runs = _case_runs(case, tmp_path_factory)
    oracle = runs["oracle"]
    assert oracle["docs"] and (case != "slab_cascade_full" or oracle["tiers"])
    for key in ("port_run", "port_from_ref", "ref_from_port"):
        _assert_run_equal(oracle, runs[key])
        assert runs[f"{key}_c"] == runs["oracle_c"], key


# ---------------------------------------------------------------------------
# the port alone


def _pipe(**window):
    return pipeline.L4Pipeline(pipeline.PipelineConfig(
        window=WindowConfig(capacity=CAP, **window), batch_size=256), device="cpu")


def _port_batches(stream, seed=7, tuples=40):
    gen = RefFlowGen(num_tuples=tuples, seed=seed)
    return [_port_batch(gen.flow_batch(n, t)) for t, n in stream]


@pytest.mark.parametrize("window", [{}, dict(async_drain=True)], ids=["sync", "async"])
def test_resume_preserves_open_and_in_flight_windows(tmp_path, window):
    """tests/test_checkpoint_misc.py:18 and :58 on the port, held bit-exact:
    a save + load between batches (with async_drain the T0+10 batch's
    block is still deferred: its windows come back in flight) emits the
    uninterrupted run's windows."""
    stream = [(T0, 100), (T0 + 1, 100), (T0 + 10, 100), (T0 + 11, 50)]

    def run(save_after):
        pipe, docs = _pipe(**window), []
        for i, fb in enumerate(_port_batches(stream)):
            docs += pipe.ingest(fb)
            if i == save_after:
                in_flight = ckpt.save_window_state(pipe.wm, tmp_path / "wm.ckpt")
                assert bool(in_flight) == bool(window)
                docs += pipe._convert_flushed(in_flight)
                pipe = _pipe(**window)
                pipe.wm = ckpt.load_window_state(tmp_path / "wm.ckpt", TAG_SCHEMA,
                                                 FLOW_METER, device="cpu")
        return docs + pipe.drain()

    want = run(None)
    assert want
    _assert_docs_equal(want, run(2))


def _saved(tmp_path, **window):
    pipe = _pipe(**window)
    pipe.ingest(_port_batches([(T0, 100)])[0])
    path = tmp_path / "wm.ckpt"
    ckpt.save_window_state(pipe.wm, path)
    return pipe, path


def test_checkpoint_truncation_fails_loudly(tmp_path):
    """tests/test_recovery.py:501: a torn file raises ValueError
    ("truncated or corrupt") from both readers; a missing one stays
    FileNotFoundError; the atomic writer leaves no temp file."""
    with pytest.raises(FileNotFoundError):
        ckpt.read_checkpoint_meta(tmp_path / "nope.ckpt")
    _, path = _saved(tmp_path)
    data = path.read_bytes()
    assert not (tmp_path / "wm.ckpt.tmp").exists()
    for cut in (10, len(data) // 2, len(data) - 3):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated or corrupt"):
            ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, device="cpu")
        with pytest.raises(ValueError, match="truncated or corrupt"):
            ckpt.read_checkpoint_meta(path)


def _rewrite(path, edit_meta=None, edit_arrays=None, *, keep_digest=False):
    """Re-serialize a checkpoint with edited meta/arrays: digested anew
    (a well-formed file of another layout) or with the stale digest."""
    meta, arrays = ckpt._read_checkpoint(path)
    if edit_meta:
        meta = edit_meta(meta)
    if edit_arrays:
        arrays = edit_arrays(arrays)
    if keep_digest:
        buf = io.BytesIO()
        np.savez_compressed(buf, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                            **arrays)
        path.write_bytes(buf.getvalue())
    else:
        meta.pop("digest", None)
        ckpt._write_checkpoint(path, meta, arrays)


def test_checkpoint_refusals_fail_loudly(tmp_path):
    """tests/test_recovery.py:527 (a valid npz whose arrays no longer
    match the digest), a v1 file, a version past v6, another kind and
    another tag width: each raises a ValueError naming it."""
    _, path = _saved(tmp_path)
    good = path.read_bytes()

    def zero_stash(arrays):
        arrays["stash_packed"] = np.zeros_like(arrays["stash_packed"])
        return arrays

    for kw, match in (
            (dict(edit_arrays=zero_stash, keep_digest=True), "digest mismatch"),
            (dict(edit_meta=lambda m: {**m, "version": 1}), "v1 is unsupported"),
            (dict(edit_meta=lambda m: {**m, "version": 7}), "not in"),
            (dict(edit_meta=lambda m: {**m, "kind": "sharded"}), "kind="),
            (dict(edit_meta=lambda m: {**m, "num_tags": m["num_tags"] + 1}), "width")):
        path.write_bytes(good)
        _rewrite(path, **kw)
        with pytest.raises(ValueError, match=match):
            ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, device="cpu")


def test_checkpoint_write_fault_keeps_the_previous_file(tmp_path):
    """An injected I/O fault at the checkpoint.io seam raises before the
    file is touched: the previous checkpoint stays, loadable."""
    pipe, path = _saved(tmp_path)
    before = path.read_bytes()
    pipe.ingest(_port_batches([(T0 + 1, 50)], seed=8)[0])
    plan = chaos.FaultPlan().add(chaos.FaultRule(chaos.SITE_CHECKPOINT_IO, at=(0,),
                                                 error=chaos.CheckpointIOError))
    with chaos.active(plan):
        with pytest.raises(chaos.CheckpointIOError):
            ckpt.save_window_state(pipe.wm, path)
    assert path.read_bytes() == before
    ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, device="cpu")


def test_load_defaults_to_cuda(tmp_path):
    """The load runs on the card unless asked for the CPU; without a card
    it raises instead of falling back."""
    _, path = _saved(tmp_path)
    if torch.cuda.is_available():
        assert ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER)


# -- sketch plane and cascade round trips (WindowManager level) ------------

_SK = _sk(SketchConfig, LogHistSpec)


def _sk_doc_batch(seed, n, t):
    """tests/test_recovery.py's sketch-stream batch, as port tensors."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 150, n).astype(np.uint32)
    tags = np.zeros((TAG_SCHEMA.num_fields, n), np.uint32)
    tags[TAG_SCHEMA.index("ip0_w3")] = keys
    tags[TAG_SCHEMA.index("server_port")] = 443
    tags[TAG_SCHEMA.index("protocol")] = 6
    tags[TAG_SCHEMA.index("l3_epc_id1")] = keys % 5
    meters = np.zeros((FLOW_METER.num_fields, n), np.float32)
    meters[FLOW_METER.index("byte_tx")] = 100.0
    meters[FLOW_METER.index("rtt_sum")] = 10.0
    meters[FLOW_METER.index("rtt_count")] = 1.0
    hi = keys * np.uint32(2654435761) + np.uint32(1)
    lo = keys ^ np.uint32(0x9E3779B9)
    u = lambda x: from_numpy_u32(x, "cpu")  # noqa: E731
    return (u(np.full(n, t, np.uint32)), u(hi), u(lo), u(tags), torch.from_numpy(meters),
            torch.ones(n, dtype=torch.bool))


def _flushed_sig(fs):
    return [(f.window_idx, f.tier, f.count, f.key_hi.tobytes(), f.tags.tobytes(),
             f.meters.tobytes()) for f in fs]


def _assert_windows_equal(want, got):
    assert _flushed_sig(want) == _flushed_sig(got)
    for a, b in zip(want, got):
        _assert_blocks_equal(a.sketches, b.sketches, f"window {a.window_idx}")


ROUND_TRIPS = {
    # tests/test_recovery.py:683: killed mid-window after T0+2
    "sketch_mid_window": (WindowConfig(capacity=1 << 11, sketch=_SK),
                          (T0, T0 + 1, T0 + 2, T0 + 5, T0 + 6), 60),
    # tests/test_recovery.py:893: mid-minute, a partly merged parent block
    "cascade_mid_minute": (WindowConfig(capacity=1 << 11, sketch=_SK,
                                        cascade=CascadeConfig(intervals=(60,),
                                                              capacity=1 << 11)),
                           (T0 - 40, T0 - 35, T0 - 30, T0 + 5, T0 + 60), 70),
}


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_manager_round_trip_killpoint(tmp_path, case):
    """A save, then process death: the restored manager's plane, tier
    stash, lanes, watermarks and pending parent blocks equal the victim's,
    and the continued run emits the uninterrupted run's windows, tier
    windows and blocks."""
    cfg, times, seed = ROUND_TRIPS[case]

    def batches():
        return [_sk_doc_batch(seed + i, 96, t) for i, t in enumerate(times)]

    oracle = WindowManager(cfg, device="cpu")
    want = [f for b in batches() for f in oracle.ingest(*b)] + oracle.flush_all()
    want_tiers = oracle.pop_tier_windows()
    path = tmp_path / "wm.ckpt"
    victim = WindowManager(cfg, device="cpu")
    got, got_tiers = [], []
    with pytest.raises(chaos.KillPoint):
        for i, b in enumerate(batches()):
            got += victim.ingest(*b)
            got_tiers += victim.pop_tier_windows()
            if i == 2:
                if victim.cascade is not None:
                    assert victim.cascade.pending_blocks[0], "no partial merge"
                got += ckpt.save_window_state(victim, path)
                raise chaos.KillPoint("process death")
    rec = ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, device="cpu")
    for f in dataclasses.fields(rec.sk):
        assert torch.equal(getattr(rec.sk, f.name), getattr(victim.sk, f.name)), f.name
    if victim.cascade is not None:
        for f in dataclasses.fields(rec.cascade.tiers[0]):
            assert torch.equal(getattr(rec.cascade.tiers[0], f.name),
                               getattr(victim.cascade.tiers[0], f.name)), f.name
        assert torch.equal(rec.cascade.lanes_dev, victim.cascade.lanes_dev)
        assert rec.cascade.watermarks == victim.cascade.watermarks
        assert sorted(rec.cascade.pending_blocks[0]) == sorted(victim.cascade.pending_blocks[0])
    for b in batches()[3:]:
        got += rec.ingest(*b)
        got_tiers += rec.pop_tier_windows()
    got += rec.flush_all()
    got_tiers += rec.pop_tier_windows()
    _assert_windows_equal(want, got)
    _assert_windows_equal(want_tiers, got_tiers)
    assert bool(want_tiers) == (victim.cascade is not None)
    for k in ("sketch_rows", "cascade_rows", "doc_in", "flushed_doc", "window_advances"):
        assert rec.get_counters()[k] == oracle.get_counters()[k], k


def _v_minus(path, version, prefixes, meta_keys):
    """Strip a port-saved file back to an older layout: drop the arrays
    and meta keys of the later formats."""
    _rewrite(path, edit_meta=lambda m: {**{k: v for k, v in m.items()
                                          if not k.startswith(meta_keys)},
                                       "version": version},
             edit_arrays=lambda a: {k: v for k, v in a.items()
                                    if not k.startswith(prefixes)})


def test_pre_v4_and_pre_v5_files_reinit_loudly(tmp_path, caplog):
    """tests/test_recovery.py:780 and :1012: a v3 layout (no sk_* arrays)
    loads with a fresh sketch plane, a v4 layout (no casc_* arrays) with
    fresh tiers, each with a loud log; the exact state is restored and
    the manager keeps working."""
    wm = WindowManager(WindowConfig(capacity=1 << 10, sketch=_SK), device="cpu")
    wm.ingest(*_sk_doc_batch(62, 64, T0))
    path = tmp_path / "v3.ckpt"
    ckpt.save_window_state(wm, path)
    _v_minus(path, 3, ("sk_",), ("sketch",))
    with caplog.at_level(logging.WARNING):
        v3 = ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, sketch_config=_SK,
                                    device="cpu")
    assert any("no sketch planes" in r.message for r in caplog.records)
    assert int(v3.sk.rows) == 0 and v3.start_window == wm.start_window
    out = v3.ingest(*_sk_doc_batch(63, 64, T0 + 5)) + v3.flush_all()
    assert any(f.sketches is not None for f in out)

    caplog.clear()
    ckpt.save_window_state(wm, path)  # a v4-era file: same config, no cascade
    with caplog.at_level(logging.WARNING):
        v4 = ckpt.load_window_state(
            path, TAG_SCHEMA, FLOW_METER, device="cpu",
            cascade_config=CascadeConfig(intervals=(60,), capacity=1 << 10))
    assert any("no cascade tier state" in r.message for r in caplog.records)
    assert v4.cascade.watermarks == [0]
    v4.ingest(*_sk_doc_batch(73, 64, T0 + 100))
    v4.flush_all()
    assert v4.pop_tier_windows()


def test_pool_geometry_change_reinits_loudly(tmp_path, caplog):
    """A slab (or v5) plane resumed into a pooled manager, or another
    pool geometry, re-initializes the plane with a loud log; another
    plane shape raises."""
    wm = WindowManager(WindowConfig(capacity=1 << 10, sketch=_SK), device="cpu")
    wm.ingest(*_sk_doc_batch(64, 64, T0))
    path = tmp_path / "slab.ckpt"
    ckpt.save_window_state(wm, path)
    pooled = dataclasses.replace(_SK, pool=_pool(PoolConfig))
    with caplog.at_level(logging.WARNING):
        got = ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, sketch_config=pooled,
                                     device="cpu")
    assert any("pool geometry" in r.message for r in caplog.records)
    assert int(got.sk.rows) == 0 and got.sk.slot_of.numel() == got.config.ring
    with pytest.raises(ValueError, match="plane shapes"):
        ckpt.load_window_state(path, TAG_SCHEMA, FLOW_METER, device="cpu",
                               sketch_config=dataclasses.replace(_SK, cms_width=512))
