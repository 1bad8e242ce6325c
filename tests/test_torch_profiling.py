"""Port of the device profiling plane: the device-memory ledger, the step
census and the span latency distributions (deepflow_tpu_torch/profiling,
utils/spans.py), held to what tests/test_profiling.py and
tests/test_sketch_onepass.py assert of the reference.

The ledger counts the port's own storages (u32 lanes are int64 tensors
here, so the bytes are not the reference's): Σ plane bytes equals the
summed sizes of exactly the distinct storages the owner's planes hold,
single-chip and sharded at D = 1 and 2, and the plane NAMES equal the
reference's for the same configuration. The census reads the sketch
plane's logical sorts — 1 with the shared sort, 2 × topk_rows with the
multi-sort oracle, 0 without top-K — the counts the reference's
jaxpr-walking tests state (they cannot run on jax 0.9.0: its census
imports `jax.core.Jaxpr`).
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import pytest

import torch

from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.aggregator.cascade import CascadeConfig as RefCascadeConfig
from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.aggregator.sketchplane import SketchConfig as RefSketchConfig
from deepflow_tpu.datamodel.schema import FLOW_METER as REF_FLOW_METER
from deepflow_tpu.datamodel.schema import TAG_SCHEMA as REF_TAG_SCHEMA
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig, SketchConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.profiling import (
    DeviceMemoryLedger,
    StepCostCensus,
    default_ledger,
    plane_bytes,
    profile_tick_sink,
)
from deepflow_tpu_torch.profiling import census as census_mod
from deepflow_tpu_torch.profiling import ledger as ledger_mod
from deepflow_tpu_torch.profiling.ledger import plane_tensors, storage_key
from deepflow_tpu_torch.utils.spans import SpanHistSpec, SpanTracer, loghist_quantiles_np

torch.set_num_threads(1)

T0 = 1_700_000_000
_SK = dict(num_groups=4, hll_precision=7, cms_depth=2, cms_width=256, topk_rows=2,
           topk_cols=64, pending=8)
_HIST = dict(bins=32, vmin=1.0, gamma=1.3)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)


def _sk(pool=False, **over):
    kw = {**_SK, **over}
    return SketchConfig(hist=LogHistSpec(**_HIST), pool=PoolConfig(**_POOL) if pool else None,
                        **kw)


def _ref_sk(pool=False, **over):
    kw = {**_SK, **over}
    return RefSketchConfig(hist=RefLogHistSpec(**_HIST),
                           pool=RefPoolConfig(**_POOL) if pool else None, **kw)


def _wkw(sketch, cascade, capacity, **wkw):
    return dict(capacity=capacity, sketch=sketch, **wkw,
                cascade=(CascadeConfig(intervals=(60,), capacity=capacity) if cascade else None))


def _mk_pipe(*, sketch=True, cascade=True, pool=False, capacity=1 << 10, bucket_sizes=None,
             **wkw):
    return L4Pipeline(PipelineConfig(
        window=WindowConfig(**_wkw(_sk(pool) if sketch else None, cascade, capacity, **wkw)),
        batch_size=256, bucket_sizes=bucket_sizes), device="cpu")


def _ingest(pipe, n=4, batch=128, seed=3, stride=1):
    gen = SyntheticFlowGen(num_tuples=150, seed=seed)
    for i in range(n):
        pipe.ingest(gen.flow_batch(batch, T0 + i * stride))
    return pipe


def _owned_storages(planes: dict) -> dict:
    """storage key → bytes over every plane: the ownership set the ledger
    claims to account."""
    out = {}
    for tree in planes.values():
        for t in plane_tensors(tree):
            out[storage_key(t)] = int(t.untyped_storage().nbytes())
    return out


def _ledger_total(owner, devices=1) -> tuple[int, dict]:
    led = DeviceMemoryLedger()
    led.register("owner", owner, devices=devices)
    rows = led.snapshot()
    return sum(r["bytes"] for r in rows), {r["plane"]: r for r in rows}


# ---------------------------------------------------------------------------
# (1) the ledger: reconciliation and the reference's plane names


@pytest.mark.parametrize("sketch,pool,cascade,wkw", [
    (True, False, True, {}),
    (True, True, False, {}),
    (False, False, False, dict(stats_ring=4)),
    (False, False, False, dict(async_drain=True)),
], ids=["slab_cascade", "pool", "ring", "async"])
def test_ledger_reconciles_single_chip(sketch, pool, cascade, wkw):
    """Σ ledger bytes == the summed sizes of the distinct storages of the
    manager's planes, after a stream that crosses a minute (tiers live);
    the plane names are the reference's for the same configuration."""
    pipe = _ingest(_mk_pipe(sketch=sketch, pool=pool, cascade=cascade, **wkw), n=4, stride=30)
    planes = pipe.wm.device_planes()
    owned = _owned_storages(planes)
    assert owned, "no device planes enumerated"
    total, rows = _ledger_total(pipe.wm)
    assert total == sum(owned.values())
    assert sum(plane_bytes(t, set())[0] for t in planes.values()) >= total  # dedup only shrinks
    for name in ("stash", "accumulator") + (("cascade",) if cascade else ()):
        assert rows[name]["bytes"] > 0, rows
    ref_cfg = ref_window.WindowConfig(
        capacity=1 << 10, sketch=_ref_sk(pool) if sketch else None,
        cascade=RefCascadeConfig(intervals=(60,), capacity=1 << 10) if cascade else None, **wkw)
    ref_wm = ref_window.WindowManager(ref_cfg, REF_TAG_SCHEMA, REF_FLOW_METER)
    assert sorted(planes) == sorted(ref_wm.device_planes())
    ref_wm.close()
    pipe.close()


@pytest.mark.parametrize("n_dev", [1, 2])
def test_ledger_reconciles_sharded(n_dev):
    from deepflow_tpu.parallel import sharded as ref_sharded
    from deepflow_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from deepflow_tpu_torch.parallel import make_mesh
    from deepflow_tpu_torch.parallel.sharded import (
        ShardedConfig,
        ShardedPipeline,
        ShardedWindowManager,
    )

    kw = dict(capacity_per_device=1 << 10, num_services=16, hll_precision=6,
              cascade=(60,), cascade_capacity=1 << 10)
    swm = ShardedWindowManager(ShardedPipeline(
        make_mesh(devices=[torch.device("cpu")] * n_dev),
        ShardedConfig(hist=LogHistSpec(bins=64, vmin=1.0, gamma=1.3), **kw)))
    gen = SyntheticFlowGen(num_tuples=150, seed=7)
    for t in (T0, T0 + 1, T0 + 70):
        fb = gen.flow_batch(64 * n_dev, t)
        swm.ingest(fb.tags, fb.meters, fb.valid)
    planes = swm.device_planes()
    total, rows = _ledger_total(swm, devices=n_dev)
    assert total == sum(_owned_storages(planes).values())
    assert rows["stash"]["devices"] == n_dev
    assert rows["stash"]["bytes_per_device"] == rows["stash"]["bytes"] // n_dev
    ref = ref_sharded.ShardedWindowManager(ref_sharded.ShardedPipeline(
        ref_make_mesh(n_dev), ref_sharded.ShardedConfig(
            hist=RefLogHistSpec(bins=64, vmin=1.0, gamma=1.3), **kw)))
    assert sorted(planes) == sorted(ref.device_planes())
    ref.close()
    # the manager sits on the default ledger with devices=D until close()
    src = [s for s in default_ledger._sources if s.owner() is swm]
    assert len(src) == 1 and src[0].devices == n_dev
    swm.close()
    assert not any(s.owner() is swm for s in default_ledger._sources)


def test_ledger_counts_a_shared_storage_once():
    base = torch.zeros(1000, dtype=torch.int64)
    assert plane_bytes([base, base[:10], base.view(10, 100)]) == (8000, 1)
    seen: set = set()
    assert plane_bytes({"a": base}, seen) == (8000, 1)
    assert plane_bytes([base[5:]], seen) == (0, 0)  # another plane's view: counted there


def test_ledger_lifecycle_construction_growth_close():
    led = DeviceMemoryLedger()
    plain = _mk_pipe(sketch=False, cascade=False)
    led.register("plain", plain.wm, interval="1s")
    rows = led.snapshot()
    assert sum(r["bytes"] for r in rows) > 0  # the stash exists before any batch
    assert not any(r["plane"] == "sketch" for r in rows)

    rich = _mk_pipe(sketch=True, cascade=True)
    led.register("rich", rich.wm, interval="1s")
    by_mod: dict = {}
    for r in led.snapshot():
        by_mod[r["module"]] = by_mod.get(r["module"], 0) + r["bytes"]
    assert by_mod["rich"] > by_mod["plain"]

    _ingest(rich, n=2)  # the ring is sized on the first batch
    rows2 = {(r["module"], r["plane"]): r for r in led.snapshot()}
    acc = rows2[("rich", "accumulator")]
    assert acc["bytes"] > 0 and acc["bytes_hwm"] >= acc["bytes"]

    assert any(s.owner() is rich.wm for s in default_ledger._sources)
    rich.close()
    assert not any(s.owner() is rich.wm for s in default_ledger._sources)
    del plain
    gc.collect()
    assert "plain" not in {r["module"] for r in led.snapshot()}


def test_ledger_transient_checkpoint_scratch(tmp_path, monkeypatch):
    from deepflow_tpu_torch.aggregator.checkpoint import save_window_state

    fresh = DeviceMemoryLedger()
    monkeypatch.setattr(ledger_mod, "default_ledger", fresh)
    pipe = _ingest(_mk_pipe(sketch=False, cascade=False), n=2)
    save_window_state(pipe.wm, tmp_path / "ck.npz")
    ck = {r["plane"]: r for r in fresh.snapshot()}["checkpoint_scratch"]
    assert ck["bytes"] == 0 and ck["bytes_hwm"] > 0  # transient: HWM only
    assert fresh.get_counters()["checkpoint_scratch_bytes_hwm"] == ck["bytes_hwm"]


def test_ledger_pending_flush_plane_under_async_drain():
    pipe = _mk_pipe(sketch=False, cascade=False, async_drain=True)
    gen = SyntheticFlowGen(num_tuples=150, seed=13)
    pipe.ingest(gen.flow_batch(128, T0))
    pipe.ingest(gen.flow_batch(128, T0 + 10))  # leaves a dispatched flush held
    planes = pipe.wm.device_planes()
    assert plane_bytes(planes["pending_flush"])[0] > 0
    total, _ = _ledger_total(pipe.wm)
    assert total == sum(_owned_storages(planes).values())
    pipe.wm.settle()
    assert plane_bytes(pipe.wm.device_planes()["pending_flush"])[0] == 0
    pipe.close()


def test_profile_tick_sink_bus_waits_for_the_push_plane():
    led = DeviceMemoryLedger()
    sink = profile_tick_sink(None, ledger=led)
    sink([object()])
    assert led.seq == 0  # no bus: nothing published, the clock stays
    with pytest.raises(NotImplementedError, match="push"):
        profile_tick_sink(object())


# ---------------------------------------------------------------------------
# (2) the step census


@pytest.fixture
def census(monkeypatch):
    """A fresh census: the default is process-wide."""
    c = StepCostCensus()
    monkeypatch.setattr(census_mod, "default_census", c)
    return c


def test_census_per_bucket_entries_and_bytes_bound(census):
    pipe = _mk_pipe(sketch=False, cascade=False, bucket_sizes=(64, 256))
    gen = SyntheticFlowGen(num_tuples=150, seed=11)
    pipe.ingest(gen.flow_batch(48, T0))        # bucket 64
    pipe.ingest(gen.flow_batch(200, T0 + 1))   # bucket 256
    pipe.ingest(gen.flow_batch(40, T0 + 2))    # 64 again
    svc = pipe._census_service
    rows = [r for r in census.snapshot() if r["service"] == svc]
    assert {r["bucket"] for r in rows} == {64, 256}
    for r in rows:
        assert r["compiles"] == 1 and r["compile_wall_s"] > 0, r
        assert r["first_dispatch_s"] == r["compile_wall_s"]
        assert r["sorts"] == 0 and r["plane_sorts"] == 0  # no pre-reduce, no sketch
        assert "flops" not in r and "bytes_accessed" not in r
    rows = {r["bucket"]: r for r in census.snapshot(analyze=True) if r["service"] == svc}
    for r in rows.values():
        assert r["bytes_accessed"] == r["argument_size_in_bytes"] + r["output_size_in_bytes"]
        assert r["argument_size_in_bytes"] > 0 and r["output_size_in_bytes"] > 0
    # the bigger bucket moves strictly more bytes (the attribution is real)
    assert rows[256]["bytes_accessed"] > rows[64]["bytes_accessed"]
    assert "flops" not in rows[256]
    tel = pipe.telemetry()
    assert tel["profile"]["hbm_bytes"]["stash"] > 0
    assert {r["bucket"] for r in tel["profile"]["census"]} == {64, 256}
    counters = census.get_counters()
    assert counters["entries"] == 2 and counters["compiles"] == 2


def test_census_service_keys_are_per_pipeline_instance(census):
    a = _mk_pipe(sketch=False, cascade=False)
    b = _mk_pipe(sketch=True, cascade=False)
    assert a._census_service != b._census_service
    gen = SyntheticFlowGen(num_tuples=100, seed=17)
    a.ingest(gen.flow_batch(128, T0))
    b.ingest(gen.flow_batch(128, T0))
    rows_a, rows_b = a.profile_snapshot()["census"], b.profile_snapshot()["census"]
    assert rows_a and rows_b
    assert all(r["service"] == a._census_service for r in rows_a)
    assert all(r["service"] == b._census_service for r in rows_b)
    a.close(), b.close()


def test_census_survives_collected_callable():
    census = StepCostCensus()

    def fn(x):
        return x * 2

    census.observe("svc", "step", 8, fn, (torch.ones(8),))
    census.note_compile("svc", "step", 8, 0.5)
    census.note_sorts("svc", "step", 8, {"sorts": 3, "plane_sorts": 1})
    assert census.seen("svc", "step", 8)
    del fn
    gc.collect()
    assert not census.seen("svc", "step", 8)  # a dead step re-observes
    row = census.snapshot(analyze=True)[0]
    assert row["analysis_error"] == "callable collected"
    assert row["compile_wall_s"] == 0.5 and row["sorts"] == 3


@pytest.mark.parametrize("shared,topk_rows,want", [
    ("1", 2, 1), ("0", 2, 4), ("1", 0, 0), ("0", 0, 0), ("0", 3, 6)],
    ids=["shared", "oracle", "shared_no_topk", "oracle_no_topk", "oracle_3rows"])
def test_census_plane_sorts(census, monkeypatch, shared, topk_rows, want):
    """tests/test_sketch_onepass.py:167-183: the plane pays 2 phases ×
    topk_rows sorts with the oracle, exactly ONE with the shared sort, and
    none without top-K. The step's own sorts add the pre-reduce's one."""
    monkeypatch.setenv("DEEPFLOW_SHARED_SORT", shared)
    pipe = L4Pipeline(PipelineConfig(
        window=WindowConfig(capacity=1 << 10, sketch=_sk(topk_rows=topk_rows)),
        batch_size=128, batch_unique_cap=128), device="cpu")
    _ingest(pipe, n=2)
    (row,) = pipe.profile_snapshot()["census"]
    assert row["plane_sorts"] == want
    assert row["sorts"] == want + 1  # + the pre-reduce's group-by sort
    pipe.close()


def test_oracle_pipeline_equals_shared_sort(monkeypatch):
    """The knob changes the sorts, never the output."""
    out = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("DEEPFLOW_SHARED_SORT", knob)
        pipe = _mk_pipe(sketch=True, cascade=False)
        gen = SyntheticFlowGen(num_tuples=150, seed=5)
        docs = [db for i in range(5) for db in pipe.ingest(gen.flow_batch(128, T0 + i))]
        docs += pipe.drain()
        out[knob] = (docs, pipe.pop_closed_sketches())
    (d1, b1), (d0, b0) = out["1"], out["0"]
    assert len(d1) == len(d0) > 0 and len(b1) == len(b0) > 0
    for a, b in zip(d1, d0):
        np.testing.assert_array_equal(a.tags, b.tags)
        np.testing.assert_array_equal(a.meters.view(np.uint32), b.meters.view(np.uint32))
    for a, b in zip(b1, b0):
        for lane in ("hll", "cms", "hist", "tk_hi", "tk_lo", "tk_ida", "tk_idb", "tk_votes"):
            np.testing.assert_array_equal(getattr(a, lane), getattr(b, lane))


# ---------------------------------------------------------------------------
# (3) span latency distributions


def test_span_hist_quantiles_match_exact_percentiles():
    tr = SpanTracer(hist_spec=SpanHistSpec(bins=512, vmin=1.0, gamma=1.02))
    rng = np.random.default_rng(0)
    durs = rng.lognormal(mean=6.0, sigma=1.0, size=4000)
    for d in durs:
        tr.record("stage.x", int(d))
    qv = tr.quantiles("stage.x", (0.5, 0.99))
    exact = np.percentile(np.floor(durs).astype(int), [50, 99])
    assert abs(qv[0] - exact[0]) / exact[0] < 0.05
    assert abs(qv[1] - exact[1]) / exact[1] < 0.05
    c = tr.get_counters()
    assert c["stage.x.p50_us"] == pytest.approx(qv[0], rel=1e-3)
    assert "p99_us" in tr.summary()["stage.x"]
    m, w = tr.tdigest("stage.x")
    assert m.dtype == np.float32 and w.sum() == pytest.approx(len(durs))
    assert sum(n for _, n in tr.hist_dump()["stage.x"]) == len(durs)
    assert tr.quantiles("never.ran") is None and tr.tdigest("never.ran") is None


def test_span_tracer_threaded_stress():
    tr = SpanTracer(ring_size=64)
    n_threads, n_rec = 8, 2000
    durs = [(t * 37 + 13) % 5000 + 1 for t in range(n_threads)]
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            tr.get_counters()
            tr.summary()
            tr.quantiles("hot")

    def writer(d):
        for _ in range(n_rec):
            tr.record("hot", d)

    readers = [threading.Thread(target=reader) for _ in range(2)]
    writers = [threading.Thread(target=writer, args=(d,)) for d in durs]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    c = tr.get_counters()
    assert c["hot.count"] == n_threads * n_rec
    assert c["hot.total_us"] == sum(d * n_rec for d in durs)
    with tr._lock:
        assert int(tr._agg["hot"].hist.sum()) == n_threads * n_rec
    assert len(tr.recent("hot")) == 64  # the ring keeps the newest


def test_loghist_quantiles_np_empty_and_point_mass():
    spec = SpanHistSpec(bins=64, vmin=1.0, gamma=1.3)
    assert (loghist_quantiles_np(np.zeros(64, np.int64), spec, (0.5, 0.99)) == 0).all()
    h = np.zeros(64, np.int64)
    h[spec.bin(100.0)] = 50
    qv = loghist_quantiles_np(h, spec, (0.1, 0.5, 0.99))
    assert np.all(qv == qv[0])
    assert abs(qv[0] - 100.0) / 100.0 < spec.gamma


def test_reference_plane_bytes_of_selfobs():
    """chip_smoke 3n prints each plane's bytes beside the reference's for
    the same configuration; the card has no JAX, so the reference's bytes
    ride in as constants. Read them from the reference itself: its
    L4Pipeline at 3n's ledger configuration (3f's stash, ring, sketch and
    cascade widths), fed 3n's seconds so it reaches the same advances,
    through its own `WindowManager.device_planes()` and `plane_bytes`.
    The ring and tier sizes depend on the capacities and the pre-reduce
    cap, not on the batch rows, so small batches stand in for 3n's."""
    import chip_smoke
    from deepflow_tpu.aggregator.pipeline import L4Pipeline as RefL4Pipeline
    from deepflow_tpu.aggregator.pipeline import PipelineConfig as RefPipelineConfig
    from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
    from deepflow_tpu.profiling.ledger import plane_bytes as ref_plane_bytes

    port = chip_smoke.sketch_config()
    sk = RefSketchConfig(
        num_groups=port.num_groups, hll_precision=port.hll_precision,
        cms_depth=port.cms_depth, cms_width=port.cms_width,
        hist=RefLogHistSpec(bins=port.hist.bins, vmin=port.hist.vmin, gamma=port.hist.gamma),
        topk_rows=port.topk_rows, topk_cols=port.topk_cols, pending=port.pending)
    cap = chip_smoke.STASH_CAPACITY
    pipe = RefL4Pipeline(RefPipelineConfig(
        window=ref_window.WindowConfig(
            capacity=cap, accum_batches=chip_smoke.ACCUM_BATCHES, delay=chip_smoke.DELAY,
            sketch=sk, cascade=RefCascadeConfig(intervals=chip_smoke.CASCADE_INTERVALS,
                                                capacity=cap)),
        batch_size=1024, batch_unique_cap=chip_smoke.UNIQUE_CAP))
    gen = RefFlowGen(num_tuples=200, seed=0)
    for dt in chip_smoke.SELFOBS_SECONDS:
        pipe.ingest(gen.flow_batch(1024, chip_smoke.T0 + dt))
    planes = pipe.wm.device_planes()
    got = {name: ref_plane_bytes(planes[name])[0] for name in chip_smoke.REF_PLANE_BYTES_3N}
    pipe.close()
    assert chip_smoke.REF_PLANE_BYTES_3N == got
