"""Crash recovery on the sharded path: the sharded checkpoint
(aggregator/checkpoint.py save_sharded_state / restore_sharded_state),
ShardedFeedSink behind the feeder runtime and its frame journal, and
the single-process topology (parallel/topology.py), against the
reference.

  * The kill-and-recover schedule of tests/test_recovery.py:44 through
    PyOverwriteQueue → FeederRuntime (FrameJournal) → ShardedFeedSink →
    ShardedWindowManager on 2 shards: uninterrupted, the port's outputs,
    counters, seam sequence, journal bytes and checkpoint file equal the
    reference's; killed at dispatch 2 (pre_advance), fetch 2 (mid_flush:
    the T0+5 advance's row-block fetch, in both packages) and dispatch 4
    (post_ckpt), each kill lands on the reference's step and recovers
    from checkpoint + journal bit-exact; each package resumes the other's
    checkpoint.
  * A 2 × 2-shard state with the cascade and pooled memory saved by
    both packages: one file (one digest, the same bytes); the port
    resumes the reference's file bit-exact.
  * The loud refusals of a sharded restore (shard count, window timing,
    capacity, fold mode, kind, topology, group, ownership) raise as the
    reference's do; `key_shard_group`, `host_path`, `describe` and the
    topology placement equal the reference's; `ShardedFeedSink` refuses
    buckets that do not divide by the shard count.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu import feeder as ref_feeder
from deepflow_tpu.aggregator import checkpoint as ref_ckpt
from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.ingest import queues as ref_queues
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu.parallel import sharded as ref_sharded
from deepflow_tpu.parallel import topology as ref_topology
from deepflow_tpu.parallel.mesh import make_mesh as ref_make_mesh
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.aggregator import checkpoint as ckpt
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig
from deepflow_tpu_torch.feeder import (
    FeederConfig,
    FeederRuntime,
    FrameJournal,
    ShardedFeedSink,
    encode_flowbatch_frames,
)
from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.parallel import make_mesh, topology
from deepflow_tpu_torch.parallel.sharded import (
    ShardedConfig,
    ShardedPipeline,
    ShardedWindowManager,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
T0 = 1_700_000_000
BUCKETS = (64, 128, 256)
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
LAST_CKPT = 5
_HIST = dict(bins=64, vmin=1.0, gamma=1.3)
_CFG = dict(capacity_per_device=1 << 10, num_services=16, hll_precision=6)
COUNTERS = ("flow_in", "flushed_doc", "drop_before_window", "window_advances")
# tests/test_recovery.py:275 — (seam, call index); the step each lands on
# is read from the reference's own seam sequence
KILLS = {
    "pre_advance": (chaos.SITE_DISPATCH, 2),
    "mid_flush": (chaos.SITE_FETCH, 2),
    "post_ckpt": (chaos.SITE_DISPATCH, 4),
}


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    chaos.uninstall()
    ref_chaos.uninstall()


_FRAMES = None


def _frame_stream():
    global _FRAMES
    if _FRAMES is None:
        gen = SyntheticFlowGen(num_tuples=150, seed=31)
        _FRAMES = {i: encode_flowbatch_frames(gen.flow_batch(n, t), max_rows_per_frame=64)
                   for i, (kind, *args) in enumerate(STEPS) if kind == "batch"
                   for t, n in (args,)}
    return _FRAMES


@dataclasses.dataclass
class _Ctx:
    swm: object
    q: object
    feeder: object
    ckpt: object
    save_fn: object
    restore_fn: object

    def save(self, barrier):
        return self.save_fn(self.swm, self.ckpt, extra_meta=barrier)

    def restore(self, path=None):
        self.restore_fn(self.swm, path or self.ckpt)

    def counters(self):
        c = self.swm.get_counters()
        return {k: c[k] for k in COUNTERS}


def _port_ctx(tmp, jname):
    swm = ShardedWindowManager(ShardedPipeline(make_mesh(devices=[CPU] * 2), ShardedConfig(
        hist=LogHistSpec(**_HIST), **_CFG)))
    q = PyOverwriteQueue(1 << 12)
    feeder = FeederRuntime([q], ShardedFeedSink(swm, BUCKETS), FeederConfig(frames_per_queue=128),
                           journal=FrameJournal(tmp / jname))
    return _Ctx(swm, q, feeder, tmp / "swm.ckpt", ckpt.save_sharded_state,
                ckpt.restore_sharded_state)


def _ref_ctx(tmp, jname):
    swm = ref_sharded.ShardedWindowManager(ref_sharded.ShardedPipeline(
        ref_make_mesh(2), ref_sharded.ShardedConfig(hist=RefLogHistSpec(**_HIST), **_CFG)))
    q = ref_queues.PyOverwriteQueue(1 << 12)
    feeder = ref_feeder.FeederRuntime(
        [q], ref_feeder.ShardedFeedSink(swm, BUCKETS),
        ref_feeder.FeederConfig(frames_per_queue=128), journal=ref_feeder.FrameJournal(tmp / jname))
    return _Ctx(swm, q, feeder, tmp / "swm.ckpt", ref_ckpt.save_sharded_state,
                ref_ckpt.restore_sharded_state)


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
    outputs += ctx.swm.drain()
    return True


def _execute(ctx, frames, start=0):
    outputs, marks = [], []
    for i in range(start, len(STEPS)):
        _step(ctx, i, frames, outputs)
        marks.append(len(outputs))
    return outputs, marks


class _SeamLog:
    """A rule-less plan recording, per STEPS index, the seams this
    thread fires (a reference pipeline in a background thread — the
    mesh-harness prewarm of tests/conftest.py — fires its own)."""

    def __init__(self, plan_cls):
        self.plan = plan_cls()
        self.seq = []
        self.step = 0
        fire, tid = self.plan.fire, threading.get_ident()

        def logged(site):
            if threading.get_ident() == tid:
                self.seq.append((self.step, site))
            fire(site)

        self.plan.fire = logged


def _logged_run(ctx, frames, plan_cls, install, uninstall):
    log = _SeamLog(plan_cls)
    install(log.plan)
    outputs, marks = [], []
    try:
        for i in range(len(STEPS)):
            log.step = i
            _step(ctx, i, frames, outputs)
            marks.append(len(outputs))
    finally:
        uninstall()
    return outputs, marks, log.seq


_RUNS: dict = {}


def _oracles(tmp_path_factory) -> dict:
    """The uninterrupted schedule in both packages (once per module):
    outputs, marks, counters, seam sequences and their directories."""
    if not _RUNS:
        for name, mk, mod in (("port", _port_ctx, chaos), ("ref", _ref_ctx, ref_chaos)):
            d = tmp_path_factory.mktemp(name)
            ctx = mk(d, "j.bin")
            out, marks, seq = _logged_run(ctx, _frame_stream(), mod.FaultPlan, mod.install,
                                          mod.uninstall)
            ctx.feeder._journal.close()
            _RUNS[name] = dict(out=out, marks=marks, seq=seq, counters=ctx.counters(), dir=d)
    return _RUNS


def _assert_outputs_bit_exact(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.tags, b.tags)
        assert a.meters.tobytes() == b.meters.tobytes()  # f32 bit-exact


def test_sharded_schedule_equals_reference(tmp_path_factory):
    """Uninterrupted: outputs, marks, counters and the seam sequence
    equal the reference's; the journal and the last checkpoint are the
    same bytes."""
    runs = _oracles(tmp_path_factory)
    port, ref = runs["port"], runs["ref"]
    _assert_outputs_bit_exact(port["out"], ref["out"])
    assert port["marks"] == ref["marks"]
    assert port["counters"] == ref["counters"]
    assert port["seq"] == ref["seq"]
    assert [s for _, s in port["seq"]].count(chaos.SITE_DISPATCH) == 6
    assert (port["dir"] / "j.bin").read_bytes() == (ref["dir"] / "j.bin").read_bytes()
    assert (port["dir"] / "swm.ckpt").read_bytes() == (ref["dir"] / "swm.ckpt").read_bytes()
    meta = ckpt.read_checkpoint_meta(port["dir"] / "swm.ckpt")
    assert meta["kind"] == "sharded" and meta["n_devices"] == 2 and meta["journal_epoch"] == 1


def _landing_step(seq, site, index) -> int:
    """The STEPS index of the `index`-th call at `site` in a seam log."""
    return [step for step, s in seq if s == site][index]


@pytest.mark.parametrize("kill", list(KILLS))
def test_sharded_kill_and_recover_bit_exact(tmp_path, tmp_path_factory, kill):
    """Kill a victim at the reference's kill-point, recover on a fresh
    stack from checkpoint + journal alone, finish the schedule: outputs
    and counters equal the uninterrupted run's, and the kill lands on
    the step it lands on in the reference."""
    runs = _oracles(tmp_path_factory)
    site, index = KILLS[kill]
    frames = _frame_stream()
    vdir = tmp_path / "victim"
    vdir.mkdir()
    vctx = _port_ctx(vdir, "j1.bin")
    outputs, durable, killed_at = [], 0, None
    rule = chaos.FaultRule(site, at=(index,), error=chaos.KillPoint())
    with chaos.active(chaos.FaultPlan().add(rule)):
        for i in range(len(STEPS)):
            try:
                if _step(vctx, i, frames, outputs):
                    durable = len(outputs)
            except chaos.KillPoint:
                killed_at = i
                break
    assert killed_at == _landing_step(runs["ref"]["seq"], site, index)
    if kill == "mid_flush":
        assert STEPS[killed_at] == ("batch", T0 + 5, 90)
    survivors = outputs[:durable]
    rctx = _port_ctx(vdir, "j2.bin")
    barrier = None
    if vctx.ckpt.exists():
        meta = ckpt.read_checkpoint_meta(vctx.ckpt)
        barrier = {k: meta[k] for k in ("journal_epoch", "journal_offset")}
        rctx.restore()
    recovered = rctx.feeder.replay_journal(vdir / "j1.bin", barrier=barrier)
    recovered += rctx.feeder.pump()
    rest, _ = _execute(rctx, frames, start=killed_at + 1)
    _assert_outputs_bit_exact(survivors + recovered + rest, runs["port"]["out"])
    assert rctx.counters() == runs["port"]["counters"]


@pytest.mark.parametrize("way", ["port_resumes_reference", "reference_resumes_port"])
def test_each_package_resumes_the_others_checkpoint(tmp_path, tmp_path_factory, way):
    """The other package's last checkpoint (taken at the second barrier,
    the journal rotated there) restored into a fresh stack, then the rest
    of the schedule: the outputs after the barrier and the counters equal
    the uninterrupted run's."""
    runs = _oracles(tmp_path_factory)
    src, mk = (("ref", _port_ctx) if way == "port_resumes_reference"
               else ("port", _ref_ctx))
    ctx = mk(tmp_path, "j.bin")
    ctx.restore(runs[src]["dir"] / "swm.ckpt")
    got, _ = _execute(ctx, _frame_stream(), start=LAST_CKPT + 1)
    _assert_outputs_bit_exact(got, runs["ref"]["out"][runs["ref"]["marks"][LAST_CKPT]:])
    assert ctx.counters() == runs["ref"]["counters"]


# ---------------------------------------------------------------------------
# a 2 × 2-shard state with the cascade and pooled memory

_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)
_CASC = dict(_CFG, cms_width=1 << 9, accum_batches=2, cascade=(60, 3600),
             cascade_capacity=1 << 10, fold_mode="merge")
CASC_SECONDS = [0, 1, 30, 41, 42, 43, 115]
SAVE_AFTER = 4  # after T0+41: mid-minute, the parent blocks partly merged


def _casc_port():
    return ShardedWindowManager(ShardedPipeline(make_mesh(devices=[CPU] * 4, n_hosts=2),
                                                ShardedConfig(hist=LogHistSpec(**_HIST),
                                                              sketch_pool=PoolConfig(**_POOL),
                                                              **_CASC)))


def _docs(dbs) -> list:
    return [(int(db.timestamp[0]), db.tags.tolist(), db.meters.view(np.uint32).tolist())
            for db in dbs]


def _stream_out(swm, batches) -> tuple:
    out = []
    for fb in batches:
        out += swm.ingest(fb.tags, fb.meters, fb.valid)
    out += swm.drain()
    return (_docs(out), [(iv, _docs([db])) for iv, db in swm.pop_tier_docbatches()],
            [(b.window, b.n_updates, np.asarray(b.hll).tolist())
             for b in swm.pop_closed_sketches() + swm.closed_tier_sketches])


def test_cascade_pool_checkpoint_same_file_and_cross_resume(tmp_path):
    """Both packages save one D = 4 state (2 × 2, merge fold, pooled
    memory, minute + hour tiers mid-minute): the files carry one digest
    and are the same bytes; the port resumes the reference's file and
    emits what the uninterrupted reference emits."""
    from jax import shard_map

    gen = RefFlowGen(num_tuples=150, seed=23)
    batches = [gen.flow_batch(4 * 48, T0 + s) for s in CASC_SECONDS]
    # the reference's sharded tier step needs check_vma=False under JAX
    # 0.9.0 (tests/test_torch_sharded_cascade.py): this test process only
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_sharded, "shard_map", functools.partial(shard_map, check_vma=False))
        ref = ref_sharded.ShardedWindowManager(ref_sharded.ShardedPipeline(
            ref_make_mesh(4, n_hosts=2), ref_sharded.ShardedConfig(
                hist=RefLogHistSpec(**_HIST), sketch_pool=RefPoolConfig(**_POOL), **_CASC)))
        port = _casc_port()
        head = batches[:SAVE_AFTER]
        for fb in head:
            assert _docs(ref.ingest(fb.tags, fb.meters, fb.valid)) == _docs(
                port.ingest(fb.tags, fb.meters, fb.valid))
        ref_ckpt.save_sharded_state(ref, tmp_path / "ref.ckpt")
        ckpt.save_sharded_state(port, tmp_path / "port.ckpt")
        r_meta = ref_ckpt.read_checkpoint_meta(tmp_path / "ref.ckpt")
        assert ckpt.read_checkpoint_meta(tmp_path / "port.ckpt") == r_meta
        assert (tmp_path / "ref.ckpt").read_bytes() == (tmp_path / "port.ckpt").read_bytes()
        assert r_meta["n_devices"] == 4 and len(r_meta["cascade_lanes"]) == 4
        # blocks closed before the save are host-side only, not in the file
        ref.pop_closed_sketches()
        ref.closed_tier_sketches.clear()
        want = _stream_out(ref, batches[SAVE_AFTER:])
    resumed = ckpt.restore_sharded_state(_casc_port(), tmp_path / "ref.ckpt")
    got = _stream_out(resumed, batches[SAVE_AFTER:])
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) >= 2


# ---------------------------------------------------------------------------
# refusals, topology, feeder sink


def _refusal(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_restore_refusals_match_reference(tmp_path_factory, tmp_path):
    """Each mismatch is refused with the reference's message: shard count,
    window timing, capacity, fold mode, a single-chip file, a topology-
    less manager given a multi-group file, another topology."""
    runs = _oracles(tmp_path_factory)
    path = runs["port"]["dir"] / "swm.ckpt"

    def both(port_kw, ref_kw, n=2, delay=2, p=path):
        return (
            _refusal(lambda: ckpt.restore_sharded_state(ShardedWindowManager(ShardedPipeline(
                make_mesh(devices=[CPU] * n), ShardedConfig(hist=LogHistSpec(**_HIST),
                                                            **{**_CFG, **port_kw})),
                delay=delay), p)),
            _refusal(lambda: ref_ckpt.restore_sharded_state(ref_sharded.ShardedWindowManager(
                ref_sharded.ShardedPipeline(ref_make_mesh(n), ref_sharded.ShardedConfig(
                    hist=RefLogHistSpec(**_HIST), **{**_CFG, **ref_kw})), delay=delay), p)),
        )

    cases = {
        "devices": both({}, {}, n=4),
        "window timing": both({}, {}, delay=5),
        "capacity_per_device": both({"capacity_per_device": 1 << 9},
                                    {"capacity_per_device": 1 << 9}),
        "fold_mode": both({"fold_mode": "merge"}, {"fold_mode": "merge"}),
    }
    for what, (port_msg, ref_msg) in cases.items():
        assert what in port_msg and port_msg == ref_msg
    # a single-chip file is refused by kind
    meta, arrays = ckpt._read_checkpoint(path)
    meta = dict(meta, kind="window")
    meta.pop("digest")
    ckpt._write_checkpoint(tmp_path / "window.ckpt", meta, arrays)
    port_msg, ref_msg = both({}, {}, p=tmp_path / "window.ckpt")
    assert "kind='window'" in port_msg and port_msg == ref_msg
    # a file saved under a 2-group topology cannot enter a bare manager
    meta = dict(meta, kind="sharded", process_index=0, process_count=1, n_groups=2,
                devices_per_group=2, topology_epoch=0, shard_group=0)
    ckpt._write_checkpoint(tmp_path / "topo.ckpt", meta, arrays)
    port_msg, ref_msg = both({}, {}, p=tmp_path / "topo.ckpt")
    assert "topology" in port_msg and port_msg == ref_msg


def test_validate_restore_and_ownership_match_reference(tmp_path):
    """MeshTopology.validate_restore and the ownership-transfer checks on
    the same metas: the same refusals, word for word."""
    devs = jax.devices()
    p_topo = topology.MeshTopology.single(2, devices_per_group=2, devices=[CPU] * 4)
    r_topo = ref_topology.MeshTopology.single(2, devices_per_group=2, devices=devs[:4])
    assert p_topo.describe() == r_topo.describe()
    metas = [dict(process_count=2, n_groups=2, devices_per_group=2),
             dict(process_count=1, n_groups=4, devices_per_group=1),
             dict(process_count=1, n_groups=2, devices_per_group=2),
             dict(n_devices=2)]
    passed = []
    for meta in metas:
        got = []
        for topo in (p_topo, r_topo):
            try:
                topo.validate_restore(meta, "f.ckpt")
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], meta
        passed.append(got[0] is None)
    assert passed == [False, False, True, True]
    own = [dict(process_index=0), dict(process_index=1),
           dict(process_index=1, handover=dict(to_process=0, group=1, topology_epoch=0)),
           dict(process_index=1, handover=dict(to_process=0, group=0, topology_epoch=3)),
           dict(process_index=0, handover=dict(to_process=1, group=0, topology_epoch=1)),
           dict(process_index=1, handover=dict(to_process=0, group=0, topology_epoch=0))]
    outcomes = []
    for meta in own:
        got = []
        for fn in (ckpt._validate_ownership_transfer, ref_ckpt._validate_ownership_transfer):
            topo = p_topo if fn is ckpt._validate_ownership_transfer else r_topo
            try:
                fn(meta, topo, 0, "f.ckpt")
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], meta
        outcomes.append(got[0] is None)
    assert outcomes == [True, False, False, False, False, True]


def test_topology_placement_matches_reference():
    """key_shard_group on seeded arrays and scalars, host_path, describe,
    group ownership and rebalance epochs equal the reference's; a remote
    group's mesh is refused."""
    rng = np.random.default_rng(5)
    org = rng.integers(0, 2 ** 16, 4096, dtype=np.uint32)
    agent = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for n in (1, 3, 8, 1000):
        got = topology.key_shard_group(org, agent, n)
        np.testing.assert_array_equal(got, ref_topology.key_shard_group(org, agent, n))
        assert got.dtype == np.int64
        assert (topology.key_shard_group(int(org[7]), int(agent[7]), n)
                == ref_topology.key_shard_group(int(org[7]), int(agent[7]), n))
    for w_p, w_r in zip(topology.agent_key_words(org, agent),
                        ref_topology.agent_key_words(org, agent)):
        np.testing.assert_array_equal(w_p, w_r)
    # three local devices: the two block groups and one adopted group
    p = topology.MeshTopology.standalone(1, 2, n_groups=4, devices_per_group=1,
                                         devices=[CPU] * 3)
    r = ref_topology.MeshTopology.standalone(1, 2, n_groups=4, devices_per_group=1,
                                             devices=jax.devices()[:3])
    for topo_p, topo_r in ((p, r), (p.rebalanced(0, 1), r.rebalanced(0, 1))):
        assert topo_p.describe() == topo_r.describe()
        assert topo_p.owned_groups() == topo_r.owned_groups()
        assert [topo_p.group_process(g) for g in range(4)] == [
            topo_r.group_process(g) for g in range(4)]
        for g in (None, 0, 3):
            assert topo_p.host_path("/j/feeder.journal", group=g) == topo_r.host_path(
                "/j/feeder.journal", group=g)
        assert topo_p.group_for_agent(7, 99) == topo_r.group_for_agent(7, 99)
    mesh = p.rebalanced(0, 1).group_mesh(0)
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("host", "chip")
    with pytest.raises(ValueError, match="owned by process 0"):
        p.group_mesh(0)
    with pytest.raises(ValueError, match="divide evenly"):
        topology.MeshTopology(process_index=0, process_count=2, n_groups=3,
                              devices_per_group=1, local_devices=(CPU,))


def test_topology_pipeline_checkpoint_carries_describe(tmp_path):
    """A pipeline built from a MeshTopology saves the topology's meta and
    its group, and a manager of another group refuses the file."""
    topo = topology.MeshTopology.single(2, devices_per_group=2, devices=[CPU] * 4)
    cfg = ShardedConfig(hist=LogHistSpec(**_HIST), **_CFG)
    swm = ShardedWindowManager(ShardedPipeline(topo, cfg, shard_group=1))
    gen = SyntheticFlowGen(num_tuples=50, seed=3)
    fb = gen.flow_batch(64, T0)
    swm.ingest(fb.tags, fb.meters, fb.valid)
    ckpt.save_sharded_state(swm, tmp_path / "g1.ckpt")
    meta = ckpt.read_checkpoint_meta(tmp_path / "g1.ckpt")
    assert {k: meta[k] for k in topo.describe()} == topo.describe()
    assert meta["shard_group"] == 1
    other = ShardedWindowManager(ShardedPipeline(topo, cfg, shard_group=0))
    with pytest.raises(ValueError, match="holds shard group 1"):
        ckpt.restore_sharded_state(other, tmp_path / "g1.ckpt")
    same = ckpt.restore_sharded_state(
        ShardedWindowManager(ShardedPipeline(topo, cfg, shard_group=1)), tmp_path / "g1.ckpt")
    assert same.get_counters()["flow_in"] == swm.get_counters()["flow_in"]
    feeder = same.make_feeder([PyOverwriteQueue(16)], (64,), journal_dir=tmp_path)
    assert feeder._journal.path.name == "feeder.journal.g1.p0of1"
    with pytest.raises(ValueError, match="MeshTopology"):
        ShardedWindowManager(ShardedPipeline(make_mesh(devices=[CPU] * 2), cfg)).make_feeder(
            [PyOverwriteQueue(16)], (64,), journal_dir=tmp_path)


def test_sharded_feed_sink_bucket_validation():
    """Buckets must divide by the shard count, with the reference's
    message; the shed count lands only with the batch."""
    swm = ShardedWindowManager(ShardedPipeline(make_mesh(devices=[CPU] * 4), ShardedConfig(
        hist=LogHistSpec(**_HIST), **_CFG)))
    ref_swm = ref_sharded.ShardedWindowManager(ref_sharded.ShardedPipeline(
        ref_make_mesh(4), ref_sharded.ShardedConfig(hist=RefLogHistSpec(**_HIST), **_CFG)))
    port_msg = _refusal(lambda: ShardedFeedSink(swm, (64, 130, 254)))
    assert port_msg == _refusal(lambda: ref_feeder.ShardedFeedSink(ref_swm, (64, 130, 254)))
    assert "[130, 254]" in port_msg
    sink = ShardedFeedSink(swm, (64, 128))
    assert sink.bucket_sizes == (64, 128) and sink.feeder_shed == 0
