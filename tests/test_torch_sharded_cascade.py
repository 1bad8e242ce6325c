"""Port parity for the sharded rollup cascade (ShardedConfig.cascade =
(60, 3600): per-shard minute and hour tier stashes, tier rows riding the
advance drain's two fetches, tier sketch blocks merged across shards).

The same seeded stream — 1 s windows across a minute boundary, then a
jump that closes the next minute and a drain that closes the hour — goes
through the JAX package's ShardedWindowManager and the port's, at D = 2
with the slab plane and the full fold, and at D = 4 (2 × 2) with pooled
memory and the merge fold. Bit-equal: the 1 s and tier DocBatches, the
merged tier sketch blocks, each shard's tier stashes and cascade lanes
after every ingest, and every counter (the bytes fetched as the
reference's less its padding, tests/test_torch_sharded.py `Padding`).
The port stays within 3 fetches per ingest.

Under JAX 0.9.0 the reference's sharded tier step fails its own
`shard_map` type check (the two `lax.cond` branches of
cascade._tier_step_impl disagree on the varying-manual-axes type), so
this module runs it with `check_vma=False`: the module-level name
`deepflow_tpu.parallel.sharded.shard_map` is patched for this module's
tests only, before any reference pipeline is built. No reference file
changes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from deepflow_tpu.aggregator.sketchplane import PoolConfig as RefPoolConfig
from deepflow_tpu.ingest.replay import SyntheticFlowGen
from deepflow_tpu.ops.histogram import LogHistSpec as RefLogHistSpec
from deepflow_tpu.parallel import sharded as ref_sharded
from deepflow_tpu.parallel.mesh import make_mesh as ref_make_mesh
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig
from deepflow_tpu_torch.ops.histogram import LogHistSpec
from deepflow_tpu_torch.parallel import make_mesh
from deepflow_tpu_torch.parallel.sharded import (
    ShardedConfig,
    ShardedPipeline,
    ShardedWindowManager,
)
from tests.test_torch_sharded import Padding, fetched_bytes_equal

torch.set_num_threads(1)

CPU = torch.device("cpu")
T0 = 1_700_000_000  # 20 s into its minute
SYNC_BUDGET = 3
_HIST = dict(bins=64, vmin=1.0, gamma=1.3)
_POOL = dict(compact_slots=3, wide_slots=1, cms_factor=8, topk_factor=4, hist_factor=8,
             promote_fill=0.5)
_BASE = dict(capacity_per_device=1 << 10, num_services=16, hll_precision=6,
             cms_width=1 << 9, accum_batches=2, cascade=(60, 3600),
             cascade_capacity=1 << 10)
CASES = [("slab_full", 2), ("pool_merge", 4)]
# minute [T0 − 20, T0 + 40) closes on the one-window advance of T0+42;
# the jump to T0+115 closes [T0 + 40, T0 + 100); the drain closes the
# last minute and the hour
SECONDS = [0, 1, 3, 7, 12, 18, 30, 38, 41, 42, 43, 46, 115]
ROWS_PER_SHARD = 48


@pytest.fixture(scope="module", autouse=True)
def _reference_without_vma_check():
    """The reference's sharded tier step needs check_vma=False under JAX
    0.9.0 (module docstring); patched in this test process only."""
    from jax import shard_map

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_sharded, "shard_map", functools.partial(shard_map, check_vma=False))
        yield


def _managers(variant: str, d: int):
    ref_kw = dict(_BASE, hist=RefLogHistSpec(**_HIST))
    port_kw = dict(_BASE, hist=LogHistSpec(**_HIST))
    if variant == "pool_merge":
        ref_kw.update(sketch_pool=RefPoolConfig(**_POOL), fold_mode="merge")
        port_kw.update(sketch_pool=PoolConfig(**_POOL), fold_mode="merge")
    hosts = 2 if d == 4 else 1
    return (ref_sharded.ShardedWindowManager(ref_sharded.ShardedPipeline(
                ref_make_mesh(d, n_hosts=hosts), ref_sharded.ShardedConfig(**ref_kw))),
            ShardedWindowManager(ShardedPipeline(
                make_mesh(devices=[CPU] * d, n_hosts=hosts), ShardedConfig(**port_kw))))


def _docs(dbs) -> list:
    return [(int(db.timestamp[0]), db.size, db.tags.tolist(),
             np.asarray(db.meters).view(np.uint32).tolist()) for db in dbs]


def _block(b) -> tuple:
    return (b.window, b.n_updates) + tuple(
        np.asarray(getattr(b, f)).tolist()
        for f in ("hll", "cms", "hist", "tk_hi", "tk_lo", "tk_ida", "tk_idb", "tk_votes"))


def _tier_state(swm) -> dict:
    out = {}
    for i, tiers in enumerate(swm.tier_stashes):
        if isinstance(tiers, list):  # the port: one stash per shard
            arrays = convert.sharded_to_numpy(tiers)
        else:
            arrays = {f.name: np.asarray(getattr(tiers, f.name))
                      for f in dataclasses.fields(tiers)}
        out.update({f"tier{i}.{k}": v for k, v in arrays.items()})
    lanes = swm.cascade_lanes
    out["lanes"] = (np.stack([x.numpy() for x in lanes]).astype(np.uint32)
                    if isinstance(lanes, list) else np.asarray(lanes))
    out["watermarks"] = np.asarray(swm.tier_watermarks)
    return out


_RUNS: dict = {}


def _run(variant: str, d: int) -> dict:
    key = (variant, d)
    if key not in _RUNS:
        ref, port = _managers(variant, d)
        pad = Padding(port)
        gen = SyntheticFlowGen(num_tuples=150, seed=11)
        rec = {n: {"docs": [], "tiers": [], "state": [], "counters": [], "fetches": [],
                   "padding": []} for n in ("ref", "port")}
        for s in SECONDS:
            fb = gen.flow_batch(ROWS_PER_SHARD * d, T0 + s)
            for name, m in (("ref", ref), ("port", port)):
                r = rec[name]
                f0 = m.get_counters()["host_fetches"]
                r["docs"].append(_docs(m.ingest(fb.tags, fb.meters, fb.valid)))
                r["fetches"].append(m.get_counters()["host_fetches"] - f0)
                r["tiers"].append([(iv, _docs([db])) for iv, db in m.pop_tier_docbatches()])
                r["state"].append(_tier_state(m))
                r["counters"].append(m.get_counters())
                r["padding"].append((pad.drain, pad.snapshot))
        for name, m in (("ref", ref), ("port", port)):
            r = rec[name]
            r["docs"].append(_docs(m.drain()))
            r["tiers"].append([(iv, _docs([db])) for iv, db in m.pop_tier_docbatches()])
            r["counters"].append(m.get_counters())
            r["padding"].append((pad.drain, pad.snapshot))
            r["tier_blocks"] = [_block(b) for b in m.closed_tier_sketches]
            r["blocks"] = [_block(b) for b in m.pop_closed_sketches()]
        _RUNS[key] = rec
    return _RUNS[key]


@pytest.mark.parametrize("variant,d", CASES)
def test_sharded_cascade_docbatches_bit_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["docs"] == run["ref"]["docs"]
    assert run["port"]["blocks"] == run["ref"]["blocks"]


@pytest.mark.parametrize("variant,d", CASES)
def test_sharded_cascade_tier_docbatches_bit_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["tiers"] == run["ref"]["tiers"]
    got = [iv for step in run["ref"]["tiers"] for iv, _ in step]
    assert got.count(60) >= 3 and got.count(3600) >= 1, got


@pytest.mark.parametrize("variant,d", CASES)
def test_sharded_cascade_tier_sketch_blocks_bit_equal(variant, d):
    run = _run(variant, d)
    assert run["port"]["tier_blocks"] == run["ref"]["tier_blocks"]
    assert len(run["ref"]["tier_blocks"]) >= 3


@pytest.mark.parametrize("variant,d", CASES)
def test_sharded_cascade_tier_state_bit_equal(variant, d):
    """Each shard's tier stashes, the cascade lanes and the watermarks
    after every ingest (the tier steps, ring folds and compacting tier
    flushes run inside)."""
    run = _run(variant, d)
    for i, (a, b) in enumerate(zip(run["ref"]["state"], run["port"]["state"])):
        assert a.keys() == b.keys(), i
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"ingest {i} {k}")


@pytest.mark.parametrize("variant,d", CASES)
def test_sharded_cascade_counters_and_fetch_budget(variant, d):
    run = _run(variant, d)
    # the bytes fetched are the reference's less its padding, tier rows
    # included (tests/test_torch_sharded.py test_manager_counters_equal)
    fetched_bytes_equal(run["port"]["counters"], run["ref"]["counters"],
                        run["port"]["padding"])
    assert run["port"]["padding"][-1][0] > 0
    last = run["port"]["counters"][-1]
    assert last["cascade_rows"] > 0 and last["cascade_tier_windows"] >= 4
    assert max(run["port"]["fetches"]) <= SYNC_BUDGET, run["port"]["fetches"]
