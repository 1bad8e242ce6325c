"""Port parity for the sharded path (deepflow_tpu_torch/parallel/).

The same seeded flow batches go through the JAX package's
`ShardedWindowManager` (on virtual CPU devices, tests/conftest.py) and
the port's (shards placed on the CPU with `devices=[cpu] * D`), at D = 2
on one host and D = 4 as 2 hosts × 2 chips, so the two-axis `pod_1m`
merge runs. Both must come out bit-equal:

  * after every ingest, each shard's stash, accumulator ring and sketch
    plane, lane for lane (the per-shard step, full and merge folds and
    range flushes run inside);
  * the DocBatches of every ingest and of the drain (meter bits
    included), the closed sketch blocks merged across shards, every
    `get_counters()` (host fetches included; the bytes fetched less the
    reference's padding, `Padding`), every forced `snapshot_open()`, and the `window_close` views and `pod_1m` of
    every advance — with the slab plane, with pooled memory and the
    merge fold, and with the per-shard pre-reduce (`batch_unique_cap`);
  * `ShardedPipeline.step` / `fold` / `flush_range` called directly,
    from one state carried across by `convert.sharded_*_numpy`.

On the port alone: the ≤ 3-fetch budget per ingest at D = 1 and D = 4
(tests/test_perf_gate.py:195) and ≤ 2 per snapshot, counted at the
`aggregator.window.host_fetch` seam; the merge-mode guards of
tests/test_merge_fold.py:349 and :434; `make_mesh` placement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.ingest.replay import SyntheticFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu.parallel import sharded as ref_sharded
from deepflow_tpu.parallel.mesh import make_mesh as ref_make_mesh
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import window
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.parallel import make_mesh
from deepflow_tpu_torch.parallel.sharded import (
    ShardedConfig,
    ShardedPipeline,
    ShardedWindowManager,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
T0 = 1_700_000_000
SYNC_BUDGET = 3  # tests/test_perf_gate.py
_HIST = dict(bins=64, vmin=1.0, gamma=1.3)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)
_BASE = dict(capacity_per_device=1 << 10, num_services=16, hll_precision=6,
             cms_width=1 << 9, accum_batches=2)
# (variant, D): each is one reference compile set. "cap" is the slab
# plane + full fold + per-shard pre-reduce on 2 × 2 shards, "pool_merge"
# pooled memory + the merge fold on 2 shards
CASES = [("pool_merge", 2), ("cap", 4)]
# seconds of the stream: two batches in T0, a late batch (T0+1 after
# T0+4 moved the span to T0+2), one-window advances, a three-window jump
SECONDS = [0, 0, 1, 2, 3, 4, 1, 5, 6, 9]
SNAPSHOT_AFTER = (2, 5, 8)
ROWS_PER_SHARD = 64


def _kw(variant: str) -> tuple[dict, dict]:
    """(reference, port) ShardedConfig keywords of a variant."""
    ref = dict(_BASE, hist=RefLogHistSpec(**_HIST))
    port = dict(_BASE, hist=LogHistSpec(**_HIST))
    if variant == "pool_merge":
        ref.update(sketch_pool=RefPoolConfig(**_POOL), fold_mode="merge")
        port.update(sketch_pool=PoolConfig(**_POOL), fold_mode="merge")
    if variant == "cap":
        ref.update(batch_unique_cap=48)
        port.update(batch_unique_cap=48)
    return ref, port


def _meshes(d: int):
    hosts = 2 if d == 4 else 1
    return ref_make_mesh(d, n_hosts=hosts), make_mesh(devices=[CPU] * d, n_hosts=hosts)


def _managers(variant: str, d: int):
    ref_kw, port_kw = _kw(variant)
    rmesh, pmesh = _meshes(d)
    return (ref_sharded.ShardedWindowManager(
                ref_sharded.ShardedPipeline(rmesh, ref_sharded.ShardedConfig(**ref_kw))),
            ShardedWindowManager(ShardedPipeline(pmesh, ShardedConfig(**port_kw))))


def _docs(dbs) -> list:
    return [(int(db.timestamp[0]), db.size, db.tags.tolist(),
             np.asarray(db.meters).view(np.uint32).tolist(), db.valid.tolist()) for db in dbs]


def _block(b) -> tuple:
    return (b.window, b.n_updates) + tuple(
        np.asarray(getattr(b, f)).tolist()
        for f in ("hll", "cms", "hist", "tk_hi", "tk_lo", "tk_ida", "tk_idb", "tk_votes"))


def _snapshot(s) -> list:
    return [(w.window_idx, w.start_time, w.count, w.partial, np.asarray(w.key_hi).tolist(),
             np.asarray(w.key_lo).tolist(), np.asarray(w.tags).tolist(),
             np.asarray(w.meters).view(np.uint32).tolist(),
             None if w.sketches is None else _block(w.sketches)) for w in s.windows] + [
        s.open_from, s.seq]


def _ref_state(swm) -> dict:
    out = {f"stash.{f.name}": np.asarray(getattr(swm.stash, f.name))
           for f in dataclasses.fields(swm.stash)}
    out.update({f"acc.{f.name}": np.asarray(getattr(swm.acc, f.name))
                for f in dataclasses.fields(swm.acc)})
    out.update({f"sk.{f.name}": np.asarray(getattr(swm.sketches, f.name))
                for f in dataclasses.fields(swm.sketches)})
    return out


def _port_state(swm) -> dict:
    out = {f"stash.{k}": v for k, v in convert.sharded_to_numpy(swm.stash).items()}
    out.update({f"acc.{k}": v for k, v in
                convert.sharded_to_numpy(swm.acc, convert.accum_to_numpy).items()})
    out.update({f"sk.{k}": v for k, v in
                convert.sharded_to_numpy(swm.sketches, convert.sketch_to_numpy).items()})
    return out


def _view(swm):
    if swm.global_view is None:
        return None
    v = swm.global_view
    if isinstance(v.hll, list):  # the port: one tensor per shard
        return [np.stack([t.numpy() for t in x]) for x in (v.hll, v.cms, v.hist, swm.pod_1m)]
    return [np.asarray(x) for x in (v.hll, v.cms, v.hist, swm.pod_1m)]


class Padding:
    """The bytes the reference's row fetches pad and the port's exact
    ones do not carry, counted as the port drains: the reference ships
    every row block (the flush rows, each tier's rows, a live read's
    rows) padded to its longest shard, and the pending sketch blocks
    with their window ids padded to the most a shard drained
    (deepflow_tpu/parallel/sharded.py `_drain_range`,
    `_read_open_snapshot`). `drain` and `snapshot` add up the u32 bytes
    of each."""

    def __init__(self, port: ShardedWindowManager):
        self.drain = self.snapshot = 0
        self._reading = False
        d = port.pipe.n_devices
        window_major, split, read = (port._window_major, port._split_drained,
                                     port._read_open_snapshot)

        def padded_rows(rows, totals):
            t = np.asarray(totals, np.int64)
            pad = 4 * rows[0].shape[1] * (d * int(t.max()) - int(t.sum()))
            if self._reading:
                self.snapshot += pad
            else:
                self.drain += pad
            return window_major(rows, totals)

        def padded_blocks(flat, total, row_cols, pend_np, wide, *rest):
            p = np.asarray(pend_np, np.int64)
            self.drain += 4 * (wide + 1) * (d * int(p.max()) - int(p.sum()))
            return split(flat, total, row_cols, pend_np, wide, *rest)

        def reading(now):
            self._reading = True
            try:
                return read(now)
            finally:
                self._reading = False

        port._window_major, port._split_drained = padded_rows, padded_blocks
        port._read_open_snapshot = reading


def fetched_bytes_equal(port_counters: dict, ref_counters: dict, pads: list) -> None:
    """Every counter equal; `bytes_fetched` and `snapshot_bytes` equal
    to the reference's less its padding (`Padding`, as of each call)."""
    for i, (port, ref, (drain, snap)) in enumerate(zip(port_counters, ref_counters, pads)):
        want = dict(ref, bytes_fetched=ref["bytes_fetched"] - drain - snap,
                    snapshot_bytes=ref["snapshot_bytes"] - snap)
        assert port == want, (i, {k: (port[k], want[k]) for k in want if port[k] != want[k]})


_RUNS: dict = {}


def _run(variant: str, d: int) -> dict:
    """Both managers over the seeded stream (cached per case): per-ingest
    outputs, states, counters, views, the snapshots and the drain."""
    key = (variant, d)
    if key not in _RUNS:
        ref, port = _managers(variant, d)
        pad = Padding(port)
        gen = SyntheticFlowGen(num_tuples=200, seed=7)
        rec = {"ref": {}, "port": {"padding": []}}
        for side in rec.values():
            for k in ("docs", "state", "counters", "views", "snapshots"):
                side[k] = []
        for i, s in enumerate(SECONDS):
            fb = gen.flow_batch(ROWS_PER_SHARD * d, T0 + s)
            for name, m, state in (("ref", ref, _ref_state), ("port", port, _port_state)):
                r = rec[name]
                r["docs"].append(_docs(m.ingest(fb.tags, fb.meters, fb.valid)))
                r["state"].append(state(m))
                r["counters"].append(m.get_counters())
                if m is port:
                    r["padding"].append((pad.drain, pad.snapshot))
                r["views"].append(_view(m))
                if i in SNAPSHOT_AFTER:
                    r["snapshots"].append(_snapshot(m.snapshot_open(force=True)))
        for name, m in (("ref", ref), ("port", port)):
            r = rec[name]
            r["docs"].append(_docs(m.drain()))
            r["counters"].append(m.get_counters())
            r["blocks"] = [_block(b) for b in m.pop_closed_sketches()]
        rec["port"]["padding"].append((pad.drain, pad.snapshot))
        _RUNS[key] = rec
    return _RUNS[key]


@pytest.mark.parametrize("variant,d", CASES)
def test_manager_docbatches_bit_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["docs"] == run["ref"]["docs"]
    assert sum(len(x) for x in run["ref"]["docs"]) >= 6


@pytest.mark.parametrize("variant,d", CASES)
def test_manager_shard_state_bit_equal(variant, d):
    """Each shard's stash, ring and sketch plane after every ingest."""
    run = _run(variant, d)
    for i, (a, b) in enumerate(zip(run["ref"]["state"], run["port"]["state"])):
        assert a.keys() == b.keys(), i
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"ingest {i} lane {k}")


@pytest.mark.parametrize("variant,d", CASES)
def test_manager_sketch_blocks_bit_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["blocks"] == run["ref"]["blocks"]
    assert len(run["ref"]["blocks"]) >= 6


@pytest.mark.parametrize("variant,d", CASES)
def test_manager_counters_equal(variant, d):
    """Every counter after every ingest (and its live read) and the
    drain: late drops, fold rows, fetches, uploads, sketch blocks, pool
    lanes. The bytes fetched differ by design: the port's row fetch
    carries each shard's rows exactly (the single card's column blocks),
    where the reference's pads every shard to the longest; so they are
    held to the reference's less that padding, byte for byte."""
    run = _run(variant, d)
    fetched_bytes_equal(run["port"]["counters"], run["ref"]["counters"],
                        run["port"]["padding"])
    assert run["port"]["padding"][-1][0] > 0 and run["port"]["padding"][-1][1] > 0
    last = run["ref"]["counters"][-1]
    assert last["drop_before_window"] > 0 and last["window_advances"] >= 5
    if variant == "pool_merge":
        assert last["sketch_promotions"] > 0


@pytest.mark.parametrize("variant,d", CASES)
def test_manager_snapshots_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["snapshots"] == run["ref"]["snapshots"]
    assert all(len(s) > 2 for s in run["ref"]["snapshots"])


@pytest.mark.parametrize("variant,d", CASES)
def test_window_close_views_bit_equal(variant, d):
    """The merged HLL / count-min / histogram view and pod_1m of every
    advance (both mesh axes at D = 4)."""
    run = _run(variant, d)
    n = 0
    for a, b in zip(run["ref"]["views"], run["port"]["views"]):
        assert (a is None) == (b is None)
        if a is not None:
            n += 1
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert n >= 5


def test_pipeline_step_fold_flush_bit_equal():
    """ShardedPipeline.step → a span-bounded merge fold → flush_range,
    called directly at D = 4 (2 × 2) from one state carried across by
    convert.sharded_*_numpy (the manager runs above hold the full fold
    and the full-set merge fold after every ingest)."""
    ref_kw, port_kw = _kw("slab")
    rmesh, pmesh = _meshes(4)
    for mode in ("merge",):
        rp = ref_sharded.ShardedPipeline(rmesh, ref_sharded.ShardedConfig(**ref_kw,
                                                                          fold_mode=mode))
        pp = ShardedPipeline(pmesh, ShardedConfig(**port_kw, fold_mode=mode))
        r_stash, r_sk = rp.init_state()
        r_acc = rp.init_acc(4 * 32)
        p_stash = convert.sharded_from_numpy(
            {f.name: np.asarray(getattr(r_stash, f.name)) for f in dataclasses.fields(r_stash)},
            pp.devices)
        p_acc = convert.sharded_from_numpy(
            {f.name: np.asarray(getattr(r_acc, f.name)) for f in dataclasses.fields(r_acc)},
            pp.devices, convert.accum_from_numpy)
        p_sk = convert.sharded_from_numpy(
            {f.name: np.asarray(getattr(r_sk, f.name)) for f in dataclasses.fields(r_sk)},
            pp.devices, convert.sketch_from_numpy)
        gen = SyntheticFlowGen(num_tuples=100, seed=3)
        off = 0
        for s in (0, 1):
            fb = gen.flow_batch(4 * 32, T0 + s)
            r_stash, r_acc, r_sk = rp.step(r_stash, r_acc, off, r_sk, fb.tags, fb.meters,
                                           fb.valid, start_window=T0 - 2)
            p_stash, p_acc, p_sk = pp.step(p_stash, p_acc, off, p_sk, fb.tags, fb.meters,
                                           fb.valid, start_window=T0 - 2)
            off += 4 * 32
        r_stash, r_acc, r_rows = rp.fold(r_stash, r_acc, hi_window=T0 + 1)
        p_stash, p_acc, p_rows = pp.fold(p_stash, p_acc, hi_window=T0 + 1)
        np.testing.assert_array_equal(np.asarray(r_rows), [int(x) for x in p_rows])
        for f in dataclasses.fields(r_stash):
            np.testing.assert_array_equal(np.asarray(getattr(r_stash, f.name)),
                                          convert.sharded_to_numpy(p_stash)[f.name], f.name)
        np.testing.assert_array_equal(np.asarray(r_acc.slot),
                                      np.stack([x.slot.numpy() for x in p_acc]))
        for f, v in convert.sharded_to_numpy(p_sk, convert.sketch_to_numpy).items():
            np.testing.assert_array_equal(np.asarray(getattr(r_sk, f)), v, f)
        r_stash, r_packed, r_tot = rp.flush_range(r_stash, T0, T0 + 1)
        p_stash, p_packed, p_tot = pp.flush_range(p_stash, T0, T0 + 1)
        tot = [int(t) for t in p_tot]
        np.testing.assert_array_equal(np.asarray(r_tot), tot)
        assert min(tot) > 0
        for k in range(4):
            np.testing.assert_array_equal(np.asarray(r_packed)[k, :tot[k]],
                                          p_packed[k][:tot[k]].numpy().view(np.uint32))
        for f in dataclasses.fields(r_stash):
            np.testing.assert_array_equal(np.asarray(getattr(r_stash, f.name)),
                                          convert.sharded_to_numpy(p_stash)[f.name], f.name)


def _counting(monkeypatch):
    counts = {"n": 0, "bytes": 0}
    real = window.host_fetch

    def counting_fetch(x):
        counts["n"] += 1
        arr = real(x)
        counts["bytes"] += arr.nbytes
        return arr

    monkeypatch.setattr(window, "host_fetch", counting_fetch)
    return counts


def test_sharded_window_ingest_host_sync_budget(monkeypatch):
    """tests/test_perf_gate.py:195 on the port: ≤ 3 fetches per ingest at
    D = 1 and D = 4, a drain ≤ 3, a snapshot ≤ 2, the budget independent
    of the shard count, and the manager's counters equal to what the
    host_fetch seam saw."""
    counts = _counting(monkeypatch)
    gen = SyntheticFlowGen(num_tuples=200, seed=5)
    per_ingest = {}
    for n_dev in (1, 4):
        _, port_kw = _kw("slab")
        wm = ShardedWindowManager(ShardedPipeline(
            make_mesh(devices=[CPU] * n_dev, n_hosts=2 if n_dev == 4 else 1),
            ShardedConfig(**port_kw)))
        n0, b0 = counts["n"], counts["bytes"]
        fetches = []
        for t in (T0, T0 + 1, T0 + 4, T0 + 104, T0 + 105):
            fb = gen.flow_batch(64 * n_dev, t)
            before = counts["n"]
            wm.ingest(fb.tags, fb.meters, fb.valid)
            fetches.append(counts["n"] - before)
        per_ingest[n_dev] = fetches
        assert max(fetches) <= SYNC_BUDGET, (n_dev, fetches)
        assert fetches[2] == 2  # an advance: one scalar + one row fetch
        before = counts["n"]
        snap = wm.snapshot_open(force=True)
        assert counts["n"] - before <= 2 and snap.windows
        before = counts["n"]
        assert wm.drain()
        assert counts["n"] - before <= SYNC_BUDGET
        c = wm.get_counters()
        assert c["host_fetches"] == counts["n"] - n0
        assert c["bytes_fetched"] == counts["bytes"] - b0
        assert c["bytes_uploaded"] > 0
    assert per_ingest[4] == per_ingest[1]


def test_sharded_ring_reinit_guard_trips_when_fold_bypassed():
    """tests/test_merge_fold.py:349: a batch larger than the ring forces a
    re-init; with the fold bypassed and rows pending, the manager raises
    instead of dropping them."""
    wm = ShardedWindowManager(ShardedPipeline(
        make_mesh(devices=[CPU]), ShardedConfig(capacity_per_device=1 << 10, num_services=16,
                                                hll_precision=6, accum_batches=2)))
    gen = SyntheticFlowGen(num_tuples=50, seed=2)
    fb = gen.flow_batch(16, 9000)
    wm.ingest(fb.tags, fb.meters, fb.valid)
    wm._fold = lambda: None
    big = gen.flow_batch(256, 9000)
    with pytest.raises(AssertionError, match="pending"):
        wm.ingest(big.tags, big.meters, big.valid)


def test_sharded_merge_mode_rejects_per_window_oracle_flush():
    """tests/test_merge_fold.py:434: merge mode refuses the per-window
    flush (its holes would break the canonical layout), and a full-mode
    pipeline refuses the span-bounded fold."""
    merge = ShardedPipeline(make_mesh(devices=[CPU]), ShardedConfig(
        capacity_per_device=1 << 8, num_services=16, hll_precision=6, fold_mode="merge"))
    stash, _ = merge.init_state()
    with pytest.raises(ValueError, match="flush_range"):
        merge.flush_window(stash, 1)
    full = ShardedPipeline(make_mesh(devices=[CPU]), ShardedConfig(
        capacity_per_device=1 << 8, num_services=16, hll_precision=6))
    stash, _ = full.init_state()
    with pytest.raises(ValueError, match="merge"):
        full.fold(stash, full.init_acc(8), hi_window=3)


def test_sketch_ring_must_cover_the_delay():
    with pytest.raises(ValueError, match="alias"):
        ShardedWindowManager(ShardedPipeline(make_mesh(devices=[CPU]), ShardedConfig(
            capacity_per_device=1 << 8, num_services=16, hll_precision=6, sketch_ring=3)),
            delay=2)


def test_make_mesh_placement():
    """Shards share a device only when placed explicitly; asking the
    visible CUDA devices for more than exist raises (here: none)."""
    mesh = make_mesh(devices=[CPU] * 4, n_hosts=2)
    assert mesh.devices.shape == (2, 2) and mesh.axis_names == ("host", "chip")
    assert mesh.size == 4 and mesh.flat() == [CPU] * 4
    with pytest.raises(ValueError, match="hosts"):
        make_mesh(devices=[CPU] * 3, n_hosts=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)
    else:
        with pytest.raises(ValueError, match="visible"):
            make_mesh(torch.cuda.device_count() + 1)
