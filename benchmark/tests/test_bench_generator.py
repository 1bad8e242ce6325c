"""The generator is deterministic by seed, and the sizes written into
the cells' sizing files follow from it (the sizing script's rule,
pinned at a tiny size)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import harness as H
from benchmark import size_mixes
from benchmark.generators.flows import FlowStream, draw_u32

from .conftest import TINY_MIX

BENCH = Path(__file__).resolve().parents[1]
TRAFFIC = BENCH / "traffic"


def _mix(name="hicard", **kw):
    mix = json.loads((TRAFFIC / f"{name}.json").read_text())
    mix.update(TINY_MIX, **kw)
    return mix


def test_same_seed_same_records_other_seed_other_records():
    seed = 2**31 + 12345  # past 32 signed bits
    a = FlowStream(_mix(), seed, "cpu").batch(1, 1_700_000_005)
    b = FlowStream(_mix(), seed, "cpu").batch(1, 1_700_000_005)
    c = FlowStream(_mix(), seed + 1, "cpu").batch(1, 1_700_000_005)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_host_batch_is_the_device_batch_restamped():
    st = FlowStream(_mix(), 9, "cpu")
    hb = st.host_batch(2)
    hb.stamp(st.time_of(7))
    tags, meters, late = st.batch(2, st.time_of(7))
    assert np.array_equal(hb.tags.astype(np.int64), tags.numpy())
    assert np.array_equal(hb.meters, meters.numpy())
    assert hb.tags.dtype == np.uint32 and hb.meters.flags["C_CONTIGUOUS"]
    assert int((late == 1).sum()) == int((hb.tags[0] == st.time_of(7) - 1).sum())


def test_late_classes_take_their_shares():
    st = FlowStream(_mix(records_per_batch=1 << 16, late=[{"seconds": 1, "share": 0.1},
                                                          {"seconds": 2, "share": 0.2}]),
                    3, "cpu")
    _, _, late = st.batch(0)
    share = torch.bincount(late, minlength=3).double() / late.shape[0]
    assert st.max_late == 2
    assert abs(float(share[1]) - 0.1) < 0.01 and abs(float(share[2]) - 0.2) < 0.01


def test_pod_ids_follow_the_client_ip():
    st = FlowStream(_mix(), 6, "cpu")
    pairs = torch.unique(torch.stack([st.pop["ip0_w3"], st.pop["pod_id"]]), dim=1)
    assert pairs.shape[1] == torch.unique(st.pop["ip0_w3"]).shape[0]


def test_draws_are_uniform_enough():
    u = draw_u32(3, 0, torch.arange(1 << 16, dtype=torch.int64))
    assert u.min() >= 0 and u.max() < 2**32
    counts = torch.bincount((u >> 28).long(), minlength=16).float()
    assert float(counts.std() / counts.mean()) < 0.05


def test_zipf_puts_the_top_tuples_first():
    st = FlowStream(_mix(), 4, "cpu")
    keys = st.keys(0)
    top = torch.bincount(keys, minlength=st.mix["tuples"])
    assert int(top[0]) > int(top[100]) > 0


def test_sizing_rule_pinned_at_a_tiny_size():
    sized = size_mixes.size_mix(_mix(), [1, 2], "cpu", delay=2, interval=1)
    assert sized["batch_raw_max"] == 1271 and sized["window_docs_max"] == 3833, sized
    assert sized["batch_unique_cap"] == 2048 and sized["capacity"] == 16384
    lc = size_mixes.size_mix(_mix("lowcard", tuples=300), [1], "cpu", delay=2, interval=1)
    assert (lc["batch_raw_max"], lc["window_docs_max"]) == (464, 995), lc


def test_sizing_counts_agree_with_independent_counts():
    """Distinct raw records are the distinct (tuple, lateness) pairs the
    generator drew; a window's documents are the reference's rows."""
    from benchmark import reference as R

    st = FlowStream(_mix(), 1, "cpu")
    _, _, late = st.batch(0)
    pairs = torch.unique(st.keys(0) * 2 + late)
    assert size_mixes.batch_raw(st, 0) == pairs.shape[0]
    w = st.start_time + 10
    k = w - st.start_time
    assert st.pool_of(k) == 1  # window_docs(st, 1) holds pool batches 1 and 2
    ref = R.rollup(R.window_parts(st, w, k + 1))
    assert size_mixes.window_docs(st, 1) == ref.tags.shape[0]


def test_sizing_files_hold_the_sizes_their_counts_give():
    """Each cell's sizing file follows from its counts by the rule, with
    the ring of the cell's own configuration."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        path = BENCH / "sizing" / f"{cell['config']}.{cell['traffic']}.json"
        sizing = json.loads(path.read_text())
        s = sizing["measured"]
        window = H.load_spec(cell["name"]).config["pipeline"]["config"]["window"]
        ring = window["delay"] // window["interval"] + 2
        assert s["batch_unique_cap"] == size_mixes.next_pow2(s["batch_raw_max"])
        assert s["capacity"] == size_mixes.next_pow2(ring * s["window_docs_max"])
        assert sizing["overlay"] == size_mixes.sizing_overlay(s)
        assert window["capacity"] == s["capacity"]
