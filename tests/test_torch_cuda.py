"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and nvcc: a CUDA kernel has no CPU mode, so
here on a CPU-only machine they skip. This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py pins JAX to the CPU backend.) The
full-width checks are chip_smoke.py's; these are the small, seeded ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_mesh_harness as th  # tests/: JAX-free, like this file

from deepflow_tpu_torch.ops import segreduce, sketch_fused, topk
from deepflow_tpu_torch.ops.segment import segment_ids, sort_keys, sort_perm
from deepflow_tpu_torch.ops.u32 import from_numpy_u32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _sketch_case(dev, seed, n, *, ring=4, g=4, m=256, d_cms=4, w_cms=1024, d_tk=2, c_tk=64,
                 keys=300, weights=(0, 3, 3, 90, 2 ** 31 - 1), mask_heads=False):
    """One phase's `sketch_update_fused` keywords on the card, built as
    the plane builds them (shared sort, run sums under the mask), a
    filled plane and top-K lanes. `mask_heads` masks out the head row of
    every other run while its other rows stay live."""
    rng = np.random.default_rng(seed)
    u32 = lambda size: rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    kid = rng.integers(0, keys, n)
    win, hi, lo = (from_numpy_u32(x, dev) for x in (
        rng.integers(50, 54, n), (kid * 2654435761 + 7).astype(np.uint32),
        (kid ^ 0x9E3779B9).astype(np.uint32)))
    s_pos = sort_perm(win, hi, lo)
    s_win, s_hi, s_lo = win[s_pos], hi[s_pos], lo[s_pos]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = (s_win[1:] != s_win[:-1]) | (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    run_id = torch.cumsum(head, 0) - 1
    mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    if mask_heads and n:
        heads = s_pos[head & (run_id % 2 == 0)]
        mask[heads] = False
        mask[s_pos[~head]] = True
    w = torch.from_numpy(rng.choice(weights, n).astype(np.int32)).to(dev)
    w = torch.where(mask, w, 0)
    run_w = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, run_id, w[s_pos])
    kw = dict(
        tk_shape=(d_tk, c_tk), gid=torch.from_numpy(rng.integers(0, g, n)).to(dev),
        reg=torch.from_numpy(rng.integers(0, m, n)).to(dev),
        rho=torch.from_numpy(rng.integers(1, 34, n)).to(dev), mask=mask,
        id_a=from_numpy_u32(u32(n), dev), id_b=from_numpy_u32(u32(n), dev), s_pos=s_pos,
        s_win=s_win, head=head, rw=run_w[run_id], s_hi=s_hi, s_lo=s_lo,
    )
    hll = torch.from_numpy(rng.integers(0, 20, (ring, g, m)).astype(np.int32)).to(dev)
    cms = torch.from_numpy(rng.integers(0, 999, (ring, d_cms, w_cms)).astype(np.int32)).to(dev)
    lanes = tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
        rng.integers(0, 50, (ring, d_tk, c_tk)),
        *(u32((ring, d_tk, c_tk)).view(np.int32) for _ in range(4))))
    return kw, hll, cms, lanes


def _assert_sketch_equal(kw, hll, cms, lanes):
    """Kernel vs plain on clones: hll, cms, the top-K lanes after the
    vote, got/hw everywhere and the key/id lanes where got. Returns the
    kernel's challengers."""
    hk, ck, ch_k = sketch_fused.sketch_update_fused(hll.clone(), cms.clone(), **kw)
    hp, cp, ch_p = sketch_fused.sketch_update_fused_plain(hll.clone(), cms.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(hk, hp) and torch.equal(ck, cp)
    for a, b in zip(topk._apply_challengers(lanes, ch_k), topk._apply_challengers(lanes, ch_p)):
        assert torch.equal(a, b)
    for (kg, *k_lanes, k_hw), (pg, *p_lanes, p_hw) in zip(ch_k, ch_p):
        assert torch.equal(kg, pg) and torch.equal(k_hw, p_hw)
        for a, b in zip(k_lanes, p_lanes):
            assert torch.equal(a[kg], b[kg])
    return ch_k


@pytest.mark.cuda
def test_sketch_fused_kernel_matches_plain(cuda):
    kw, hll, cms, lanes = _sketch_case(cuda, 41, 4096)
    sketch_fused.reset_launch_counts()
    _assert_sketch_equal(kw, hll, cms, lanes)
    assert sketch_fused.LAUNCHES["sketch_fused"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1000, 600_000],
                         ids=["empty", "one_row", "ragged", "past_one_grid"])
def test_sketch_fused_kernel_row_counts(cuda, n):
    """No row, one row, a count that is no multiple of the block, and
    more rows than one resident grid covers (grid-stride loops)."""
    _assert_sketch_equal(*_sketch_case(cuda, 42 + n % 97, n, keys=max(1, n // 8)))


@pytest.mark.cuda
def test_sketch_fused_kernel_masked_heads_and_wrapping_run_weights(cuda):
    """Runs whose head row is masked out (the count-min add still
    happens at the head, HLL and top-K skip it) and run weights that sum
    past 2^31 and wrap."""
    kw, hll, cms, lanes = _sketch_case(cuda, 43, 5000, keys=40, mask_heads=True,
                                       weights=(2 ** 31 - 1, 2 ** 30, 7))
    assert bool((kw["rw"] < 0).any())  # some run sum wrapped
    _assert_sketch_equal(kw, hll, cms, lanes)


@pytest.mark.cuda
def test_sketch_fused_kernel_leaves_its_table_zeroed(cuda):
    """The same inputs twice in a row give identical challengers: each
    call found its persistent scratch zeroed (by the call before it), and
    the scratch the next call takes is zero again."""
    kw, hll, cms, _ = _sketch_case(cuda, 44, 3000)
    _, _, first = sketch_fused.sketch_update_fused(hll.clone(), cms.clone(), **kw)
    first = [tuple(x.clone() for x in row) for row in first]
    _, _, second = sketch_fused.sketch_update_fused(hll.clone(), cms.clone(), **kw)
    torch.cuda.synchronize()
    for a_row, b_row in zip(first, second):
        for a, b in zip(a_row, b_row):
            assert torch.equal(a, b)
    tables, zeroed, _ = sketch_fused._TABLES[(cuda.index or 0, 2 * 4 * 64)]
    assert not bool(tables[zeroed].any()) and bool(tables[1 - zeroed].any())


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["gather", "sorted"])
def test_segreduce_kernels_match_plain(cuda, gather):
    rng = np.random.default_rng(7)
    n, m, cap = 50_000, 62, 4096
    slot, hi, lo = (from_numpy_u32(x, cuda) for x in (
        np.full(n, 9), rng.integers(0, 6000, n), np.zeros(n)))
    valid = torch.from_numpy(rng.random(n) > 0.05).to(cuda)
    rows = torch.from_numpy(rng.integers(0, 1000, (n, m)).astype(np.float32)).to(cuda)
    s_slot, s_hi, s_lo, perm = sort_keys(slot, hi, lo, valid)
    seg, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, cap)
    perm32 = perm.to(torch.int32)
    x = rows if gather else rows.index_select(0, perm)
    p = perm32 if gather else None
    ks, km = segreduce.sorted_segment_sum_max(x, seg, cap, first_pos, perm=p)
    ps, pm = segreduce.sorted_segment_sum_max_plain(x, seg, cap, first_pos, perm=p)
    live = min(int(num_seg), cap)
    # integer-valued f32 rows: every partial sum is exact in any order
    assert torch.equal(ks[:live], ps[:live]) and torch.equal(km[:live], pm[:live])


def _segments(dev, lengths, m, *, cap=None, dead=5, nan_rows=0, seed=0):
    """Segmented-reduce operands with the given live segment lengths (in
    id order), `dead` rows of ids ≥ cap after them, rows in a random
    original order (perm) with integer values (exact sums) and
    `nan_rows` NaN cells."""
    rng = np.random.default_rng(seed)
    cap = len(lengths) if cap is None else cap
    seg = np.concatenate([np.repeat(np.arange(len(lengths)), lengths),
                          np.full(dead, cap + 1)]).astype(np.int32)
    n = seg.shape[0]
    first_pos = np.searchsorted(seg, np.arange(cap), side="left").astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    rows = rng.integers(-1000, 1000, (n, m)).astype(np.float32)
    if nan_rows:
        rows[rng.integers(0, n, nan_rows), rng.integers(0, m, nan_rows)] = np.nan
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(rows), t(perm), t(seg), t(first_pos), cap, np.asarray(lengths) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["gather", "sorted"])
@pytest.mark.parametrize("m", [1, 62, 128])
@pytest.mark.parametrize("case", ["short", "crossing", "long", "absent", "last", "nan"])
def test_segreduce_kernel_segment_shapes(cuda, gather, m, case):
    """1-row and 8-row segments, segments that cross a staging batch,
    one longer than a warp's ring, absent segments (interior and past the
    live ones), a long last segment (cap = live), NaN cells — each
    against the plain version on the CPU (SUM exact on integer rows, MAX
    exact, NaN where the plain version has NaN)."""
    rng = np.random.default_rng(m)
    lengths, cap = {
        "short": (rng.choice([1, 8], 3000), None),
        "crossing": (rng.integers(14, 40, 400), None),
        "long": ([3, 5000, 2, 70], None),
        "absent": (rng.choice([0, 0, 1, 3, 8], 2000), 2600),
        "last": (list(rng.integers(1, 9, 200)) + [3000], None),
        "nan": (rng.integers(1, 50, 300), None),
    }[case]
    rows, perm, seg, first_pos, cap, live = _segments(
        cuda, lengths, m, cap=cap, nan_rows=500 if case == "nan" else 0, seed=m)
    x = rows if gather else rows.index_select(0, perm.long())
    p = perm if gather else None
    ks, km = segreduce.sorted_segment_sum_max(x, seg, cap, first_pos, perm=p)
    ps, pm = segreduce.sorted_segment_sum_max_plain(
        x.cpu(), seg.cpu(), cap, first_pos.cpu(), perm=None if p is None else p.cpu())
    torch.cuda.synchronize()
    keep = torch.from_numpy(np.flatnonzero(live))
    ks, km = ks.cpu()[keep], km.cpu()[keep]
    assert torch.equal(ks.isnan(), ps[keep].isnan()) and torch.equal(km.isnan(), pm[keep].isnan())
    assert torch.equal(ks.nan_to_num(), ps[keep].nan_to_num())
    assert torch.equal(km.nan_to_num(), pm[keep].nan_to_num())


def _ring(rng, cap, fill, windows, n_keys):
    """A ring of `fill` seeded rows on the CPU (FLOW_METER docs) over the
    windows [lo, hi), ~10% sentinel; integer-valued meters, so sums are
    exact in any order."""
    from deepflow_tpu_torch.aggregator import stash
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    acc = stash.accum_init(cap, TAG_SCHEMA, FLOW_METER, device="cpu")
    k = rng.integers(0, n_keys, fill)
    slot = rng.integers(*windows, fill)
    slot[rng.random(fill) < 0.1] = 0xFFFFFFFF
    acc.slot[:fill] = torch.from_numpy(slot)
    acc.key_hi[:fill] = torch.from_numpy(k * 2654435761 % 2 ** 32)
    acc.key_lo[:fill] = torch.from_numpy(k)
    acc.tags[:, :fill] = torch.from_numpy(rng.integers(0, 2 ** 32, (acc.tags.shape[0], fill)))
    acc.meters[:, :fill] = torch.from_numpy(
        rng.integers(0, 5000, (acc.meters.shape[0], fill)).astype(np.float32))
    return acc


def _folded(rng, cap, rows, windows, n_keys, acap):
    """A canonical stash of `cap` rows: one seeded ring folded in."""
    from deepflow_tpu_torch.aggregator import stash
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    state = stash.stash_init(cap, TAG_SCHEMA, FLOW_METER, device="cpu")
    return stash.stash_fold_counted(state, _ring(rng, acap, rows, windows, n_keys),
                                    FLOW_METER)[0]


def _merge_case(seed, scap=4096, acap=12288, n_keys=3000):
    """A canonical stash (one seeded ring folded in) and a second ring, on
    the CPU."""
    rng = np.random.default_rng(seed)
    state = _folded(rng, scap, acap - 100, (7, 11), n_keys, acap)
    return state, _ring(rng, acap, acap // 2, (7, 11), n_keys)


def _to(x, dev):
    import dataclasses

    return type(x)(**{f.name: getattr(x, f.name).clone().to(dev)
                      for f in dataclasses.fields(x)})


@pytest.mark.cuda
@pytest.mark.parametrize("hi_window", [None, 9], ids=["full_set", "span"])
def test_merge_fold_card_matches_cpu(cuda, hi_window):
    """The merge fold on the card (segreduce kernel through the merged
    order) equals the CPU's, and the card's full fold of the same rows."""
    import dataclasses

    from deepflow_tpu_torch.aggregator import stash
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER

    state, acc = _merge_case(51)
    host, host_acc, host_rows = stash.stash_merge_fold(_to(state, "cpu"), _to(acc, "cpu"),
                                                       FLOW_METER, hi_window=hi_window)
    segreduce.reset_launch_counts()
    card, card_acc, card_rows = stash.stash_merge_fold(_to(state, cuda), _to(acc, cuda),
                                                       FLOW_METER, hi_window=hi_window)
    torch.cuda.synchronize()
    assert segreduce.LAUNCHES["segreduce_gather"] == 1
    assert int(card_rows) == int(host_rows) > 0
    for f in dataclasses.fields(card):
        assert torch.equal(getattr(card, f.name).cpu(), getattr(host, f.name)), f.name
    assert torch.equal(card_acc.slot.cpu(), host_acc.slot)
    if hi_window is None:
        full, _, _ = stash.stash_fold_counted(_to(state, cuda), _to(acc, cuda), FLOW_METER)
        for f in dataclasses.fields(card):
            assert torch.equal(getattr(card, f.name), getattr(full, f.name)), f.name


@pytest.mark.cuda
def test_pooled_plane_step_card_matches_cpu(cuda):
    """Pooled sketch steps (compact seating, a promotion, compact and
    wide closes, the drain) on the card equal the CPU's, every field;
    latencies sit at bin centres so the card's logf cannot move a bin.
    Pool mode launches no sketch_fused kernel."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.aggregator import sketchplane as sp
    from deepflow_tpu_torch.ops.histogram import LogHistSpec

    spec = LogHistSpec(bins=64, vmin=1.0, gamma=1.2)
    cfg = sp.SketchConfig(num_groups=4, hll_precision=8, cms_depth=3, cms_width=512, hist=spec,
                          topk_rows=2, topk_cols=128, pending=10, pool=sp.PoolConfig())
    rng = np.random.default_rng(52)
    planes = {d: sp.sketch_init(cfg, 4, device=d) for d in ("cpu", cuda)}
    sketch_fused.reset_launch_counts()
    sw = 0
    for lo_w, keys in ((10, 400), (10, 30), (11, 400), (13, 30), (15, 400)):
        n = 512
        win = rng.integers(lo_w, lo_w + 2, n)
        kid = rng.integers(0, keys, n)
        close_w = max(sw, int(win.max()) - 2)
        base_w = max(sw, min(int(win.min()), close_w))
        sw = close_w
        x = dict(window=win, valid=rng.random(n) > 0.1, group=rng.integers(0, 4, n),
                 client_hi=rng.integers(0, 2 ** 32, n), client_lo=rng.integers(0, 2 ** 32, n),
                 key_hi=kid * 2654435761 % 2 ** 32, key_lo=kid, id_a=kid,
                 id_b=rng.integers(0, 2 ** 32, n),
                 weight=rng.integers(0, 600, n).astype(np.float32),
                 rtt=(spec.vmin * spec.gamma ** (rng.integers(0, 64, n) + 0.5)).astype(np.float32),
                 rtt_valid=rng.random(n) > 0.2)
        for d in planes:
            t = {k: torch.from_numpy(np.asarray(v)).to(d) for k, v in x.items()}
            planes[d] = sp.sketch_plane_step(planes[d], spec, base_w=base_w, close_w=close_w, **t)
        want, got = (convert.sketch_to_numpy(planes[d]) for d in ("cpu", cuda))
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert int(planes[cuda].pool_promos) > 0
    drained = [sp.sketch_drain(planes[d], 2 ** 32 - 1) for d in ("cpu", cuda)]
    for a, b in zip(drained[0][1:], drained[1][1:]):
        assert torch.equal(a, b.cpu())
    assert sketch_fused.LAUNCHES["sketch_fused"] == 0


# (fill, child rows, [lo, hi), prefix) of each tier-step branch at a
# 4096-row child stash: prefix 2048, ring 8192
_CHILD = 4096
_PREFIX = 2048
_TIER_BRANCHES = {
    "append": (_PREFIX, 3000, (118, 119), _PREFIX),
    "fold_append": (4 * _PREFIX, 3000, (118, 120), _PREFIX),
    "direct": (2 * _PREFIX, 7000, (116, 122), _PREFIX),
    "degenerate": (_PREFIX, 3000, (118, 119), _CHILD),
}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(_TIER_BRANCHES))
def test_tier_step_card_matches_cpu(cuda, branch):
    """One seeded cascade tier step per branch of the reference's
    `lax.cond` (append, fold+append, direct fold, prefix ≥ rows) on the
    card equals the CPU's: every tier-stash lane, the ring's slot lane,
    fill and the [rows, shed] lanes; the merge launches the segreduce
    kernel."""
    import dataclasses

    from deepflow_tpu_torch.aggregator import cascade, stash
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    fill, rows, (lo, hi), prefix = _TIER_BRANCHES[branch]
    rng = np.random.default_rng(60 + len(branch))
    child = _folded(rng, _CHILD, rows, (lo, hi + 2), 1200, 2 * _CHILD)
    _, packed, total = stash._flush_range_impl(child, lo, hi)
    assert (int(total) > _PREFIX) == (branch == "direct") and int(total) > 0
    tier = _folded(rng, 1024, 3000, (1, 3), 1500, 4 * _PREFIX)
    acc = _ring(rng, 4 * _PREFIX, fill, (1, 3), 1500)
    out = {}
    for d in ("cpu", cuda):
        segreduce.reset_launch_counts()
        out[d] = cascade.tier_step(
            _to(tier, d), _to(acc, d), torch.tensor(fill, device=d),
            torch.tensor([7, 3], device=d), packed.to(d), total.to(d), hi, ratio=60,
            meter_schema=FLOW_METER, num_tags=TAG_SCHEMA.num_fields, prefix=prefix)
    torch.cuda.synchronize()
    assert segreduce.LAUNCHES["segreduce_gather"] == 1
    (h_tier, h_acc, h_fill, h_lanes), (c_tier, c_acc, c_fill, c_lanes) = out["cpu"], out[cuda]
    for f in dataclasses.fields(h_tier):
        assert torch.equal(getattr(c_tier, f.name).cpu(), getattr(h_tier, f.name)), f.name
    assert torch.equal(c_acc.slot.cpu(), h_acc.slot)
    assert int(c_fill) == int(h_fill) and torch.equal(c_lanes.cpu(), h_lanes)
    assert int(h_lanes[0]) > 7


@pytest.mark.cuda
def test_stats_ring_push_card_matches_cpu(cuda):
    """Ten pushes round a K = 4 counter ring on the card and the CPU:
    every ring row and the device gate equal, with blocks whose t_max is
    below the delay, whose n_valid is 0, and whose t_max is near 2^32."""
    from deepflow_tpu_torch.aggregator import window

    rng = np.random.default_rng(70)
    blocks = rng.integers(0, 2 ** 32, (10, window.CB_LEN), dtype=np.uint64).astype(np.int64)
    blocks[:, window.CB_T_MAX] = [1, 2, 1_700_000_003, 1_700_000_001, 1_700_000_009,
                                  2 ** 32 - 1, 2 ** 32 - 3, 5, 1_700_000_020, 0]
    blocks[[1, 4, 9], window.CB_N_VALID] = 0
    out = {}
    for d in ("cpu", cuda):
        ring = torch.zeros((4, window.CB_LEN), dtype=torch.int64, device=d)
        sw = torch.tensor([1_700_000_000, 1], device=d)
        gates = []
        for i, b in enumerate(blocks):
            ring, sw = window._stats_ring_push(ring, i % 4, sw, torch.from_numpy(b).to(d),
                                               interval=1, delay=2)
            gates.append(sw.cpu())
        out[d] = (ring.cpu(), torch.stack(gates))
    torch.cuda.synchronize()
    assert torch.equal(out["cpu"][0], out[cuda][0]) and torch.equal(out["cpu"][1], out[cuda][1])
    assert int(out[cuda][1][-1, 0]) == 2 ** 32 - 3


def _doc_stream(seed, seconds, n=256, keys=400):
    """Raw doc batches (numpy: ts, hi, lo, [T, n] tags, [M, n] meters,
    valid) for WindowManager.ingest: each batch's keys are distinct, and
    no second gets more than two batches, so a key's meters sum at most
    two rows (exact in any order); latencies sit at bin centres of the
    histogram below, so the card's logf cannot move a bin."""
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    rng = np.random.default_rng(seed)
    out = []
    for dt in seconds:
        k = rng.permutation(keys)[:n].astype(np.int64)
        tags = np.zeros((TAG_SCHEMA.num_fields, n), np.int64)
        tags[TAG_SCHEMA.index("ip0_w3")] = k
        tags[TAG_SCHEMA.index("server_port")] = 443
        tags[TAG_SCHEMA.index("protocol")] = 6
        tags[TAG_SCHEMA.index("l3_epc_id1")] = k % 5
        meters = np.zeros((FLOW_METER.num_fields, n), np.float32)
        meters[FLOW_METER.index("byte_tx")] = rng.integers(1, 900, n)
        meters[FLOW_METER.index("rtt_sum")] = 1.2 ** (rng.integers(0, 64, n) + 0.5)
        meters[FLOW_METER.index("rtt_count")] = 1.0
        out.append((np.full(n, 1_700_000_000 + dt), (k * 2654435761 + 1) % 2 ** 32,
                    k ^ 0x9E3779B9, tags, meters, rng.random(n) > 0.05))
    return out


def _plane_config(pool: bool):
    from deepflow_tpu_torch.aggregator import sketchplane as sp
    from deepflow_tpu_torch.ops.histogram import LogHistSpec

    return sp.SketchConfig(num_groups=4, hll_precision=8, cms_depth=3, cms_width=512,
                           hist=LogHistSpec(bins=64, vmin=1.0, gamma=1.2), topk_rows=2,
                           topk_cols=128, pending=10,
                           pool=sp.PoolConfig(cms_factor=16) if pool else None)


def _window_sig(f):
    blk = f.sketches
    lanes = () if blk is None else (blk.window, blk.n_updates) + tuple(
        getattr(blk, k).tobytes() for k in ("hll", "cms", "hist", "tk_votes", "tk_hi",
                                            "tk_lo", "tk_ida", "tk_idb"))
    return (f.window_idx, f.count, f.partial, f.key_hi.tobytes(), f.key_lo.tobytes(),
            f.tags.tobytes(), f.meters.tobytes(), lanes)


def _manager_run(dev, batches, *, snapshots=False, pool=False, **wkw):
    """One WindowManager (slab or pooled sketch plane) over `batches`
    on `dev`: per ingest call the windows it returned (and, with
    `snapshots`, a forced snapshot's windows and the ring slots' pool
    sides), then flush_all's; every counter block."""
    from deepflow_tpu_torch.aggregator import window

    wm = window.WindowManager(window.WindowConfig(
        capacity=1 << 12, sketch=_plane_config(pool), min_snapshot_interval=0.0, **wkw),
        device=dev)
    blocks, process = [], wm._process_block
    wm._process_block = lambda vec: (blocks.append(list(vec)), process(vec))
    calls, snaps, sides = [], [], set()
    for ts, hi, lo, tags, meters, valid in batches:
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        calls.append([_window_sig(f) for f in wm.ingest(t(ts), t(hi), t(lo), t(tags),
                                                        t(meters), t(valid))])
        if snapshots:
            snaps.append([_window_sig(f) for f in wm.snapshot_open(force=True).windows])
            pc = wm.sk.p_hll.shape[0]
            sides |= {"wide" if s >= pc else "compact" for s in wm.sk.slot_of.tolist()
                      if s >= 0}
    calls.append([_window_sig(f) for f in wm.flush_all()])
    return calls, snaps, sides, blocks, wm.get_counters()


_SECONDS = [0, 0, 1, 3, 4, 4, 5, 7, 8, 8, 9, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [dict(stats_ring=4), dict(async_drain=True)],
                         ids=["stats_ring", "async"])
def test_ring_and_async_manager_card_matches_cpu(cuda, extra):
    """A K = 4 counter ring and async_drain with the slab plane and the
    full fold: each ingest call returns the same windows (rows, sketch
    blocks) on the card as on the CPU, every replayed counter block and
    the counters are equal, and the card launched both kernels."""
    from deepflow_tpu_torch.ops import segreduce

    batches = _doc_stream(71, _SECONDS)
    segreduce.reset_launch_counts()
    sketch_fused.reset_launch_counts()
    card = _manager_run(cuda, batches, **extra)
    assert segreduce.LAUNCHES["segreduce_gather"] > 0 and sketch_fused.LAUNCHES["sketch_fused"] > 0
    host = _manager_run("cpu", batches, **extra)
    assert card[0] == host[0] and sum(map(len, card[0])) > 0
    assert card[3] == host[3] and card[4] == host[4]


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["slab", "pool"])
def test_snapshot_card_matches_cpu(cuda, pool):
    """A forced snapshot after every ingest (K = 4 ring; the merge fold
    with the pool): the card's snapshot windows, their open sketch blocks
    and the flushed windows equal the CPU's; the pool's snapshots read
    compact and, after the promotion, wide slots."""
    batches = _doc_stream(72, _SECONDS)
    kw = dict(snapshots=True, pool=pool, stats_ring=4, fold_mode="merge" if pool else "full")
    card, host = _manager_run(cuda, batches, **kw), _manager_run("cpu", batches, **kw)
    assert card[1] == host[1] and sum(map(len, card[1])) > 0
    assert card[0] == host[0] and card[3] == host[3] and card[4] == host[4]
    assert card[4]["snapshot_reads"] == len(batches)
    if pool:
        assert card[2] == {"compact", "wide"}


def _ckpt_config():
    from deepflow_tpu_torch.aggregator import cascade, window

    return window.WindowConfig(capacity=1 << 12, sketch=_plane_config(False),
                               cascade=cascade.CascadeConfig(intervals=(60,), capacity=1 << 12))


def _ckpt_run(save_dev, load_dev, batches, path, save_after=5):
    """A WindowManager (slab plane, minute cascade) on `save_dev` over the
    first batches, saved to `path` and resumed on `load_dev` for the
    rest: the windows (the save's in-flight ones included), the tier
    windows, the file's digest and the counters."""
    from deepflow_tpu_torch.aggregator import checkpoint, window
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA

    wm = window.WindowManager(_ckpt_config(), device=save_dev)
    out, tiers = [], []
    for i, (ts, hi, lo, tags, meters, valid) in enumerate(batches):
        t = lambda x: torch.from_numpy(np.asarray(x)).to(wm.device)  # noqa: E731
        out += wm.ingest(t(ts), t(hi), t(lo), t(tags), t(meters), t(valid))
        tiers += wm.pop_tier_windows()
        if i == save_after:
            out += checkpoint.save_window_state(wm, path)
            wm = checkpoint.load_window_state(path, TAG_SCHEMA, FLOW_METER, device=load_dev)
    out += wm.flush_all()
    tiers += wm.pop_tier_windows()
    c = wm.get_counters()
    return ([_window_sig(f) for f in out], [(f.tier, _window_sig(f)) for f in tiers],
            checkpoint.read_checkpoint_meta(path)["digest"],
            {k: c[k] for k in ("doc_in", "flushed_doc", "window_advances", "sketch_rows",
                               "cascade_rows", "cascade_tier_windows")})


@pytest.mark.cuda
@pytest.mark.parametrize("way", ["card_to_cpu", "cpu_to_card"])
def test_checkpoint_card_and_cpu_cross_load(cuda, tmp_path, way):
    """A file saved on the card loads on the CPU, and a CPU-saved file on
    the card; both continue to the CPU run's windows, tier windows and
    counters, and the card's file has the CPU's digest. The resumed card
    side launches both kernels."""
    from deepflow_tpu_torch.ops import segreduce

    batches = _doc_stream(73, _SECONDS)
    want = _ckpt_run("cpu", "cpu", batches, tmp_path / "cpu.ckpt")
    segreduce.reset_launch_counts()
    sketch_fused.reset_launch_counts()
    save_dev, load_dev = (cuda, "cpu") if way == "card_to_cpu" else ("cpu", cuda)
    got = _ckpt_run(save_dev, load_dev, batches, tmp_path / "x.ckpt")
    assert segreduce.LAUNCHES["segreduce_gather"] > 0 and sketch_fused.LAUNCHES["sketch_fused"] > 0
    assert got == want and want[1] and sum(1 for w in want[0] if w[1]) > 0


@pytest.mark.cuda
def test_kill_point_recovered_on_card(cuda, tmp_path):
    """The mid-flush kill of the reference's matrix (host fetch 5) on the
    card: L4Pipeline behind FeederRuntime + FrameJournal, recovered from
    checkpoint + journal on a fresh card stack, emits the uninterrupted
    card run's stream and counters, which equal the CPU run's."""
    from deepflow_tpu_torch import chaos
    from deepflow_tpu_torch.aggregator import checkpoint
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.feeder import (FeederConfig, FeederRuntime, FrameJournal,
                                           PipelineFeedSink, encode_flowbatch_frames)
    from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    t0 = 1_700_000_000
    steps = [(t0, 100), (t0 + 1, 120), "ckpt", (t0 + 5, 90), (t0 + 6, 110), "ckpt",
             (t0 + 7, 80), (t0 + 10, 100), "drain"]
    gen = SyntheticFlowGen(num_tuples=150, seed=31)
    frames = [encode_flowbatch_frames(gen.flow_batch(s[1], s[0]), max_rows_per_frame=64)
              if isinstance(s, tuple) else None for s in steps]

    def stack(dev, d, jname):
        pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12),
                                         batch_size=256, bucket_sizes=(64, 128, 256)),
                          device=dev)
        q = PyOverwriteQueue(1 << 12)
        return pipe, q, FeederRuntime([q], PipelineFeedSink(pipe),
                                      FeederConfig(frames_per_queue=128),
                                      journal=FrameJournal(d / jname))

    def run(pipe, q, feeder, d, start=0, out=None, durable=None):
        out = [] if out is None else out
        for i in range(start, len(steps)):
            s = steps[i]
            if s == "ckpt":
                out += feeder.checkpoint(lambda b: [pipe._to_docbatch(f) for f in
                                                    checkpoint.save_window_state(
                                                        pipe.wm, d / "wm.ckpt", extra_meta=b)])
            elif s == "drain":
                out += feeder.flush() + pipe.drain()
            else:
                for fr in frames[i]:
                    q.put(fr)
                out += feeder.pump()
            if durable is not None and s in ("ckpt", "drain"):
                durable[0] = len(out)
        return out

    def sig(dbs):
        return [(db.timestamp.tobytes(), db.tags.tobytes(), db.meters.tobytes()) for db in dbs]

    def counters(pipe):
        c = pipe.get_counters()
        return {k: c[k] for k in ("doc_in", "flushed_doc", "drop_before_window",
                                  "window_advances", "feeder_shed")}

    want = {}
    for dev in ("cpu", cuda):
        d = tmp_path / f"oracle_{torch.device(dev).type}"
        d.mkdir()
        pipe, q, feeder = stack(dev, d, "j.bin")
        want[torch.device(dev).type] = (sig(run(pipe, q, feeder, d)), counters(pipe))
    assert want["cuda"] == want["cpu"] and want["cpu"][0]

    d = tmp_path / "victim"
    d.mkdir()
    pipe, q, feeder = stack(cuda, d, "j1.bin")
    out, durable = [], [0]
    plan = chaos.FaultPlan().add(chaos.FaultRule(chaos.SITE_FETCH, at=(5,),
                                                 error=chaos.KillPoint()))
    with chaos.active(plan):
        with pytest.raises(chaos.KillPoint):
            run(pipe, q, feeder, d, out=out, durable=durable)
    killed_at = 4  # the T0+6 pump: its dispatch of T0+5 advances and flushes
    pipe, q, feeder = stack(cuda, d, "j2.bin")
    pipe.wm = checkpoint.load_window_state(d / "wm.ckpt", TAG_SCHEMA, FLOW_METER)
    meta = checkpoint.read_checkpoint_meta(d / "wm.ckpt")
    got = out[:durable[0]] + feeder.replay_journal(d / "j1.bin", barrier={
        k: meta[k] for k in ("journal_epoch", "journal_offset")})
    got += feeder.pump()
    got = run(pipe, q, feeder, d, start=killed_at + 1, out=got)
    assert (sig(got), counters(pipe)) == want["cuda"]


def _sharded_run(dev, variant):
    """A D = 2 ShardedWindowManager with both shards on `dev` (slab plane
    + full fold, or pooled memory + merge fold + a minute cascade) over a
    seeded stream with a late batch and a forced snapshot after every
    third ingest: its DocBatches, tier DocBatches, closed blocks, the
    snapshots' rows and the counters."""
    from deepflow_tpu_torch.aggregator.sketchplane import PoolConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.histogram import LogHistSpec
    from deepflow_tpu_torch.parallel import make_mesh
    from deepflow_tpu_torch.parallel.sharded import (ShardedConfig, ShardedPipeline,
                                                     ShardedWindowManager)

    kw = dict(capacity_per_device=1 << 12, num_services=16, hll_precision=8, cms_width=1 << 10,
              hist=LogHistSpec(bins=64, vmin=1.0, gamma=1.2), accum_batches=2)
    if variant == "pool_merge_cascade":
        kw.update(sketch_pool=PoolConfig(cms_factor=16), fold_mode="merge", cascade=(60,),
                  cascade_capacity=1 << 12)
    swm = ShardedWindowManager(ShardedPipeline(make_mesh(devices=[torch.device(dev)] * 2),
                                               ShardedConfig(**kw)), min_snapshot_interval=0.0)
    gen = SyntheticFlowGen(num_tuples=400, seed=17)
    t0 = 1_700_000_000  # 20 s into its minute

    def docs(dbs):
        return [(db.timestamp.tobytes(), db.tags.tobytes(), db.meters.tobytes()) for db in dbs]

    out, snaps = [], []
    for i, s in enumerate([0, 0, 1, 3, 4, 2, 5, 8, 30, 41, 42, 43, 90]):
        fb = gen.flow_batch(512, t0 + s)
        out.append(docs(swm.ingest(fb.tags, fb.meters, fb.valid)))
        if i % 3 == 2:
            snaps.append([(w.window_idx, w.key_hi.tobytes(), w.tags.tobytes(),
                           w.meters.tobytes()) for w in swm.snapshot_open(force=True).windows])
    out.append(docs(swm.drain()))
    tiers = [(iv, docs([db])) for iv, db in swm.pop_tier_docbatches()]
    blocks = swm.pop_closed_sketches() + swm.closed_tier_sketches
    return out, tiers, blocks, snaps, swm.get_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slab_full", "pool_merge_cascade"])
def test_sharded_manager_card_matches_cpu(cuda, variant):
    """A D = 2 sharded manager with both shards on the card emits the CPU
    run's DocBatches (meter bits included), tier DocBatches, snapshots and
    counters; its closed blocks equal the CPU's in every lane but the
    histogram, whose per-group totals agree (the card's logf may move a
    count to the next bin). The slab run launched both kernels."""
    from deepflow_tpu_torch.ops import segreduce

    segreduce.reset_launch_counts()
    sketch_fused.reset_launch_counts()
    card = _sharded_run(cuda, variant)
    assert segreduce.LAUNCHES["segreduce_gather"] > 0
    if variant == "slab_full":
        assert sketch_fused.LAUNCHES["sketch_fused"] > 0
    host = _sharded_run("cpu", variant)
    assert card[0] == host[0] and sum(map(len, host[0])) >= 8
    assert card[1] == host[1] and card[3] == host[3] and card[4] == host[4]
    assert len(card[2]) == len(host[2]) > 0
    for a, b in zip(card[2], host[2]):
        assert (a.window, a.n_updates) == (b.window, b.n_updates)
        for k in ("hll", "cms", "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
        assert np.array_equal(a.hist.sum(-1), b.hist.sum(-1))
    if variant == "pool_merge_cascade":
        assert card[1] and card[4]["sketch_promotions"] > 0


def _platform_lanes(seed: int, n: int = 3000):
    """A seeded platform registry in numpy form (pods with an address, a
    MAC, a gprocess and a pod service; a share in another region)."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.enrich.platform import PlatformInfoTable

    rng = np.random.default_rng(seed)
    pt = PlatformInfoTable(my_region_id=1)
    for pod in range(1, n + 1):
        pt.add_info(epc_id=1 + pod % 7, ips=[0x0A000000 + pod], mac=0x020000000000 + pod,
                    pod_id=pod, region_id=2 if pod % 11 == 0 else 1, subnet_id=pod % 64,
                    pod_node_id=1 + pod % 50, pod_group_id=1 + pod % 300, pod_group_type=101,
                    l3_device_id=pod, l3_device_type=10)
        pt.add_gprocess(gpid=pod, agent_id=1 + pod % 4, pod_id=pod)
    for g in range(1, 301):
        pt.add_pod_service(5000 + g, pod_group_id=g, protocol=int(rng.choice([0, 6])),
                           server_port=int(rng.choice([0, 80])))
    pt.add_custom_service(77, epc_id=1, ip=0x0A000001, server_port=443)
    return convert.platform_state_to_numpy(pt.build(device="cpu"))


def _doc_tags(seed: int, n: int) -> np.ndarray:
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA as T

    rng = np.random.default_rng(seed)
    tags = np.zeros((n, T.num_fields), np.uint32)
    put = lambda k, v: tags.__setitem__((slice(None), T.index(k)), v)
    put("code_id", rng.integers(1, 9, n))
    put("agent_id", rng.integers(1, 5, n))
    put("ip0_w3", 0x0A000000 + rng.integers(0, 3500, n))
    put("ip1_w3", 0x0A000000 + rng.integers(0, 3500, n))
    put("l3_epc_id", rng.choice([1, 2, 3, 0xFFFE], n))
    put("l3_epc_id1", rng.choice([1, 2, 3], n))
    put("mac0_lo", rng.choice([0, 5, 9999], n))
    put("pod_id", rng.choice([0, 7, 12, 4000], n))
    put("gpid0", rng.integers(0, 3500, n))
    put("server_port", rng.choice([0, 80, 443], n))
    put("protocol", rng.choice([6, 17], n))
    put("tap_side", rng.choice([1, 2], n))
    put("signal_source", rng.choice([0, 4], n))
    return tags


@pytest.mark.cuda
def test_hashtable_lookup_card_matches_cpu(cuda):
    from deepflow_tpu_torch.ops.hashtable import build_table_np, table_from_lanes

    rng = np.random.default_rng(21)
    hi = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    lanes = build_table_np(hi, lo, np.arange(5000, dtype=np.uint32))
    q_hi = np.concatenate([hi, rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)])
    q_lo = np.concatenate([lo, np.full(500, 7, np.uint32)])
    got = []
    for dev in (cuda, torch.device("cpu")):
        t = table_from_lanes(*lanes, device=dev)
        v, f = t.lookup(from_numpy_u32(q_hi, dev), from_numpy_u32(q_lo, dev))
        got.append((v.cpu().numpy(), f.cpu().numpy()))
    assert np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][1], got[1][1])
    assert got[0][1][:5000].all()


@pytest.mark.cuda
def test_enrich_docs_card_matches_cpu(cuda):
    """One 8192-doc chunk (and its one packed fetch) on the card equals
    the CPU's, lane for lane."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.server.flow_metrics import enrich_chunk_host

    lanes = _platform_lanes(3)
    tags = _doc_tags(4, 8192)
    valid = np.random.default_rng(5).random(8192) < 0.97
    card = enrich_chunk_host(convert.platform_state_from_numpy(lanes, cuda), tags, valid)
    host = enrich_chunk_host(convert.platform_state_from_numpy(lanes, "cpu"), tags, valid)
    for side in (0, 1):
        assert sorted(card[side]) == sorted(host[side])
        for k in host[side]:
            assert np.array_equal(card[side][k], host[side][k]), (side, k)
    assert np.array_equal(card[2], host[2]) and card[3] == host[3] > 0
    assert (card[0]["pod_id"] != 0).any() and (card[0]["service_id"] != 0).any()


@pytest.mark.cuda
def test_downsampler_card_matches_cpu(cuda):
    """The 1 s → 1 h rollup (both unsummable choices) on the card equals
    the CPU's: tags exact, integer-valued sums exact, averages within
    rtol 1e-5; the fused-gather kernel ran."""
    from deepflow_tpu_torch.ops import segreduce
    from deepflow_tpu_torch.server.datasource import DataSource, Downsampler
    from deepflow_tpu_torch.server.metrics_tables import MetricsTableID, table_schema
    from deepflow_tpu_torch.storage.store import ColumnarStore

    t0 = 1_700_000_000 - 1_700_000_000 % 3600
    schema = table_schema(MetricsTableID.NETWORK_1S)
    rng = np.random.default_rng(8)
    n = 20_000
    cols = {}
    for c in schema.columns:
        if c.name == "time":
            cols[c.name] = (t0 + rng.integers(0, 7200, n)).astype(np.uint32)
        elif c.dtype.startswith("U"):
            cols[c.name] = np.array([f"s{i}" for i in rng.integers(0, 3, n)])
        elif c.dtype == "f4":
            cols[c.name] = rng.integers(0, 1000, n).astype(np.float32)
        elif c.name in ("tap_side", "protocol", "region_id_0", "pod_id_1"):
            cols[c.name] = rng.integers(0, 6, n).astype(np.uint32)
        else:
            cols[c.name] = np.zeros(n, np.uint32)
    for aggr in ("avg", "max"):
        out = []
        segreduce.reset_launch_counts()
        for dev in (cuda, torch.device("cpu")):
            store = ColumnarStore()
            store.create_table("flow_metrics", schema)
            store.insert("flow_metrics", "network_1s", cols)
            dsm = Downsampler(store, delay_s=0, device=dev)
            dsm.add(DataSource(base_table="network_1s", interval="1h", aggr_unsummable=aggr))
            dsm.process(t0 + 3 * 3600)
            out.append(store.scan("flow_metrics", "network_1h"))
        assert segreduce.LAUNCHES["segreduce_gather"] == 2
        card, host = out
        assert len(card["time"]) == len(host["time"]) > 0
        for k in host:  # group order is the key order on both
            if host[k].dtype.kind == "f" and not np.array_equal(host[k], np.round(host[k])):
                np.testing.assert_allclose(card[k], host[k], rtol=1e-5, err_msg=k)
            else:
                assert np.array_equal(card[k], host[k]), k


def _log_rows(rng, n, schema, *, slots=3, keys=400):
    """Merge rows for a flow-log stash: few (slot, key) pairs so
    segments span stash and batch, random u32 ints (OR lanes with high
    bits), integer-valued f32 nums below 2^24."""
    k = rng.integers(0, keys, n)
    return (rng.integers(0, slots, n).astype(np.uint32),
            (k * 2654435761 % (1 << 32)).astype(np.uint32), (k % 7).astype(np.uint32),
            rng.integers(0, 2 ** 32, (n, len(schema.ints)), dtype=np.uint64).astype(np.uint32),
            np.floor(rng.random((n, len(schema.nums))) * 1e4).astype(np.float32),
            rng.random(n) < 0.9)


@pytest.mark.cuda
def test_log_stash_merge_and_minute_aggr_card_match_cpu(cuda):
    """The flow-log merge (3 merges past capacity, then every minute
    flushed) and a MinuteAggr stream with a drain on the card equal the
    CPU's lane for lane."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.flowlog import aggr
    from deepflow_tpu_torch.flowlog.schema import L4_FLOW_LOG

    rng = np.random.default_rng(21)
    states = {d: aggr.log_stash_init(1024, L4_FLOW_LOG, d) for d in (cuda, "cpu")}
    for _ in range(3):
        rows = _log_rows(rng, 512, L4_FLOW_LOG)
        for d in states:
            states[d] = aggr.log_stash_merge(states[d], *aggr.upload_rows(*rows, d), L4_FLOW_LOG)
    card, host = (convert.log_stash_to_numpy(states[d]) for d in (cuda, "cpu"))
    for k in host:
        assert np.array_equal(card[k], host[k]), k
    for minute in range(3):
        outs = {}
        for d in states:
            states[d], out = aggr._log_flush(states[d], minute)
            n = int(out["count"])
            outs[d] = aggr.pack_rows(out["ints"][:n], out["nums"][:n]).cpu().numpy()
        assert np.array_equal(outs[cuda], outs["cpu"]) and len(outs["cpu"])

    ma = {d: aggr.MinuteAggr(capacity=4096, batch_size=2048, device=d) for d in (cuda, "cpu")}
    got = {d: [] for d in ma}
    for b in range(6):
        n = 2048
        ints = rng.integers(0, 1 << 16, (n, len(L4_FLOW_LOG.ints))).astype(np.uint32)
        flow = rng.integers(0, 900, n)
        ints[:, L4_FLOW_LOG.int_index("flow_id_hi")] = flow * 7919
        ints[:, L4_FLOW_LOG.int_index("flow_id_lo")] = flow
        ints[:, L4_FLOW_LOG.int_index("end_time")] = 1_700_000_000 + 30 * b + rng.integers(0, 20, n)
        nums = np.floor(rng.random((n, len(L4_FLOW_LOG.nums))) * 1e3).astype(np.float32)
        for d in ma:
            got[d] += ma[d].ingest(aggr.FlowLogBatch(L4_FLOW_LOG, ints, nums, np.ones(n, bool)))
    for d in ma:
        got[d] += ma[d].drain()
    assert len(got[cuda]) == len(got["cpu"]) > 1
    for g, w in zip(got[cuda], got["cpu"]):
        assert np.array_equal(g.ints, w.ints) and np.array_equal(g.nums, w.nums)
    assert ma[cuda].get_counters() == ma["cpu"].get_counters()


@pytest.mark.cuda
def test_flow_map_tick_card_matches_cpu(cuda):
    """FlowMap inject + tick over crafted TCP/UDP sessions (FIN, RST,
    resends, a handshake across the 2^32 µs wrap) on the card equals the
    CPU's: every emission, the table lane for lane, the seq_tracker;
    inject fetches nothing and a tick at most twice."""
    from deepflow_tpu_torch import convert
    from deepflow_tpu_torch.agent import flow_map, packet
    from deepflow_tpu_torch.agent.packet import TCP_ACK, TCP_FIN, TCP_PSH, TCP_RST, TCP_SYN

    t0 = next(s for s in range(1_700_000_000, 1_700_010_000)
              if (s * 1_000_000) % (1 << 32) > (1 << 32) - 900_000)
    us0 = (1 << 32) - 100 - (t0 * 1_000_000) % (1 << 32)
    srv = 0x0A000002
    steps = []
    for t in range(4):
        pkts, us = [], []
        for c in range(300):
            cli, sport = 0x0A010000 + c % 97, 30000 + c
            if t == 0:
                pkts += [packet.craft_tcp(cli, srv, sport, 443, flags=TCP_SYN, seq=1),
                         packet.craft_tcp(srv, cli, 443, sport, flags=TCP_SYN | TCP_ACK, seq=9,
                                          ack=2),
                         packet.craft_tcp(cli, srv, sport, 443, flags=TCP_ACK, seq=2, ack=10)]
                us += [us0, us0 + 300 + c, us0 + 500 + c]
            seq = 2 + 100 * t if c % 11 else 2  # every 11th resends its first segment
            pkts.append(packet.craft_tcp(cli, srv, sport, 443, flags=TCP_ACK | TCP_PSH, seq=seq,
                                         payload=b"x" * 100))
            us.append(us0 + 600)
            if t == 2 and c % 7 == 0:
                flags = TCP_RST if c % 2 else TCP_FIN | TCP_ACK
                pkts += [packet.craft_tcp(cli, srv, sport, 443, flags=flags, seq=seq + 100),
                         packet.craft_tcp(srv, cli, 443, sport, flags=flags, seq=10)]
                us += [us0 + 700, us0 + 800]
            if c % 13 == 0:
                pkts.append(packet.craft_udp(cli, srv, 5000 + c, 53, b"q" * 20))
                us.append(us0 + 50)
        steps.append((pkts, us, t0 + t))
    maps = {d: flow_map.FlowMap(capacity=2048, batch_size=2048, device=d) for d in (cuda, "cpu")}
    for pkts, us, t in steps:
        p = packet.parse_packets(*packet.to_batch(pkts, [t] * len(pkts), us))
        out = {}
        for d, m in maps.items():
            before = m.host_fetches
            m.inject(p)
            assert m.host_fetches == before
            out[d] = m.tick(t + 1)
            assert m.host_fetches - before <= 2
        assert out[cuda].size == out["cpu"].size > 0
        assert np.array_equal(out[cuda].ints, out["cpu"].ints)
        assert np.array_equal(out[cuda].nums, out["cpu"].nums)
        card, host = (convert.flow_map_state_to_numpy(maps[d]) for d in (cuda, "cpu"))
        for k in host["stash"]:
            assert np.array_equal(card["stash"][k], host["stash"][k]), k
        assert list(card["seq_tracker"].items()) == list(host["seq_tracker"].items())
    drained = {d: m.drain(t0 + 99) for d, m in maps.items()}
    assert np.array_equal(drained[cuda].ints, drained["cpu"].ints)
    assert maps[cuda].get_counters() == maps["cpu"].get_counters()


@pytest.mark.cuda
def test_sql_float32_sums_card_equal_cpu(cuda):
    """The SQL engine's float32 segment sums add each segment's rows in
    row order on the card too, so a 200,000-row group sums to the CPU's
    (and the reference's) float32 value bit for bit; max and min agree."""
    from deepflow_tpu_torch.querier.engine import _segment_reduce

    rng = np.random.default_rng(13)
    for n, g in ((200_000, 1), (60_000, 4), (100_000, 5000)):
        v = rng.random(n) * 1e5
        gid = rng.integers(0, g, n)
        for op in ("sum", "amax", "amin"):
            card = _segment_reduce(v, gid, g + 1, op, cuda)
            host = _segment_reduce(v, gid, g + 1, op, torch.device("cpu"))
            assert np.array_equal(card, host), (n, g, op)


# ---------------------------------------------------------------------------
# the standalone sketch functions and the device-memory ledger


def _run_sketch_fns(dev, seed=21):
    """HLL / count-min / log-histogram / top-K / t-digest through init,
    update, merge and estimate / query / quantiles on `dev`."""
    from deepflow_tpu_torch.ops import cms, histogram, hll, tdigest

    rng = np.random.default_rng(seed)
    n = 20_000
    kid = rng.integers(0, 3000, n)
    hi = from_numpy_u32((kid * 2654435761 + 1).astype(np.uint32), dev)
    lo = from_numpy_u32((kid ^ 0x9E3779B9).astype(np.uint32), dev)
    gid = torch.from_numpy(rng.integers(0, 4, n)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    w = torch.from_numpy(rng.integers(1, 900, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.lognormal(6.0, 1.5, n).astype(np.float32)).to(dev)
    spec = histogram.LogHistSpec(bins=1024, vmin=1.0, gamma=1.02)
    regs = hll.hll_update(hll.hll_init(4, 14, device=dev), gid, hi, lo, valid)
    regs = hll.hll_merge(regs, hll.hll_update(hll.hll_init(4, 14, device=dev), gid, lo, hi,
                                              valid))
    plane = cms.cms_update(cms.cms_init(4, 1 << 16, device=dev), hi, lo, w, valid)
    plane = cms.cms_merge(plane, plane)
    hist = histogram.loghist_update(histogram.loghist_init(4, spec, device=dev), gid, vals,
                                    valid, spec)
    hist = histogram.loghist_merge(hist, hist)
    lanes = topk.topk_update(topk.topk_init(2, 1024, 2, device=dev), gid % 3, hi, lo, lo, hi,
                             w, valid)
    m, wt = tdigest.tdigest_from_loghist(hist, spec)
    m2, w2 = tdigest.tdigest_merge(m[0], wt[0], m[1], wt[1])
    qs = torch.tensor([0.5, 0.95, 0.99], device=dev)
    ints = {"hll": regs, "cms": plane, "hist": hist, "cms_query": cms.cms_query(plane, hi, lo),
            **{f"topk{i}": x for i, x in enumerate(lanes)}}
    floats = {"hll_estimate": hll.hll_estimate(regs),
              "loghist_quantiles": histogram.loghist_quantiles(hist, spec, (0.5, 0.95, 0.99)),
              "tdigest_means": m, "tdigest_weights": wt, "merged_means": m2,
              "merged_weights": w2, "tdigest_quantile": tdigest.tdigest_quantile(m2, w2, qs)}
    return ints, floats


@pytest.mark.cuda
def test_standalone_sketch_functions_card_equal_cpu(cuda):
    card_i, card_f = _run_sketch_fns(cuda)
    host_i, host_f = _run_sketch_fns(torch.device("cpu"))
    for k in host_i:
        assert torch.equal(card_i[k].cpu(), host_i[k]), k
    for k in host_f:
        torch.testing.assert_close(card_f[k].cpu(), host_f[k], rtol=1e-5, atol=0, msg=k)


@pytest.mark.cuda
def test_ledger_bytes_within_allocated_and_fetch_free(cuda):
    import gc

    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.histogram import LogHistSpec
    from deepflow_tpu_torch.profiling import DeviceMemoryLedger

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    sk = SketchConfig(num_groups=8, hll_precision=10, cms_depth=4, cms_width=1 << 12,
                      hist=LogHistSpec(bins=256, vmin=1.0, gamma=1.05), topk_rows=2,
                      topk_cols=256, pending=16)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 14, sketch=sk),
                                     batch_size=4096), device=cuda)
    gen = SyntheticFlowGen(num_tuples=2000, seed=1)
    for t in range(4):
        pipe.ingest(gen.flow_batch(4096, 1_700_000_000 + t))
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    led = DeviceMemoryLedger()
    led.register("window_manager", pipe.wm)
    fetches = pipe.wm.host_fetches
    total = sum(r["bytes"] for r in led.snapshot())
    assert pipe.wm.host_fetches == fetches  # a snapshot fetches nothing
    assert 0 < total <= delta
    pipe.close()


def _lineage_stream(dev, lineage: bool):
    """A small slab L4Pipeline stream with a live read and a drain; with
    `lineage`, a LineageTracker on a frozen clock. Returns the windows,
    host fetches and (with lineage) what the tracker recorded."""
    import dataclasses

    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.sketchplane import SketchConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.ops.histogram import LogHistSpec
    from deepflow_tpu_torch.tracing.lineage import FreshnessTracker, LineageTracker

    sk = SketchConfig(num_groups=4, hll_precision=8, cms_depth=2, cms_width=512,
                      hist=LogHistSpec(bins=64, vmin=1.0, gamma=1.2), topk_rows=2,
                      topk_cols=64, pending=8)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(
        capacity=1 << 13, sketch=sk, stats_ring=4, min_snapshot_interval=0.0),
        batch_size=2048), device=dev)
    clock = [2e9]
    lin = fr = None
    if lineage:
        fr = FreshnessTracker(autoregister=False)
        lin = LineageTracker("tpu.pipeline", 1, freshness=fr, clock=lambda: clock[0])
        pipe.attach_lineage(lin)
    gen = SyntheticFlowGen(num_tuples=800, seed=5)
    docs = []
    for i in range(7):
        clock[0] = 2e9 + 10.0 * i
        docs += pipe.ingest(gen.flow_batch(2048, 1_700_000_000 + i))
        if i == 3:
            pipe.snapshot_open(force=True)
    docs += pipe.drain()
    out = {"docs": [(db.timestamp.tobytes(), db.tags.tobytes(), db.meters.tobytes())
                    for db in docs], "fetches": pipe.wm.host_fetches}
    if lineage:
        out["spans"] = [dataclasses.astuple(r) for r in lin.drain_spans()]
        out["fresh"] = fr.get_counters()
        lin.close()
    return out


@pytest.mark.cuda
def test_lineage_adds_no_fetch_and_records_as_the_cpu(cuda):
    passive = _lineage_stream(cuda, False)
    card = _lineage_stream(cuda, True)
    host = _lineage_stream(torch.device("cpu"), True)
    assert card["fetches"] == passive["fetches"] == host["fetches"]
    assert card["docs"] == passive["docs"] == host["docs"]
    assert card["spans"] and card["spans"] == host["spans"]
    assert card["fresh"] == host["fresh"]


def _subscription_results(dev):
    """A WindowManager's closed windows into a store through the bus-aware
    sink; one SQL and one PromQL standing query record every delivery."""
    from deepflow_tpu_torch.aggregator.window import WindowConfig, WindowManager
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER, TAG_SCHEMA
    from deepflow_tpu_torch.integration import dfstats
    from deepflow_tpu_torch.querier.events import QueryEventBus, connect_store_events
    from deepflow_tpu_torch.querier.live import LiveRegistry
    from deepflow_tpu_torch.querier.subscribe import SubscriptionManager
    from deepflow_tpu_torch.storage.store import ColumnarStore

    store = ColumnarStore()
    dfstats.ensure_system_table(store)
    bus = QueryEventBus(name="cuda-subs")
    connect_store_events(store, bus)
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False, bus=bus, device=dev)
    sql, prom = [], []
    db, table = dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE
    subs.subscribe_sql(f"SELECT Sum(value) AS s, Max(value) AS m FROM {db}.{table}",
                       callback=lambda r, s: sql.append([list(map(float, r.values[c]))
                                                         for c in r.columns]))
    subs.subscribe_promql(f"sum({dfstats.LIVE_METRIC_FLOW_BYTES})", span_s=6, step=1, db=db,
                          table=table, lookback_s=3, callback=lambda r, s: prom.append(r))
    wm = WindowManager(WindowConfig(capacity=1 << 12), device=dev)
    sink = dfstats.flow_window_sink(store, bus=bus)
    rng = np.random.default_rng(3)
    for s in range(8):
        n = 300
        keys = rng.integers(0, 90, n).astype(np.uint32)
        tags = np.zeros((TAG_SCHEMA.num_fields, n), np.uint32)
        tags[TAG_SCHEMA.index("server_port")] = keys
        meters = np.zeros((FLOW_METER.num_fields, n), np.float32)
        meters[FLOW_METER.index("byte_tx")] = rng.random(n).astype(np.float32) * 1e4
        out = wm.ingest(np.full(n, 1_700_000_000 + s, np.uint32), keys * np.uint32(2654435761),
                        keys ^ np.uint32(0x9E3779B9), tags, meters, np.ones(n, bool))
        if out:
            sink([f for f in out if f.count])
    sink([f for f in wm.flush_all() if f.count])
    subs.close()
    return sql, prom


@pytest.mark.cuda
def test_subscriptions_card_equal_cpu(cuda):
    card = _subscription_results(cuda)
    host = _subscription_results(torch.device("cpu"))
    assert card[0] and card == host


@pytest.mark.cuda
def test_two_process_mesh_on_the_card_equals_the_cpu_oracle(cuda, tmp_path):
    """The harness's two-process run over MeshTopology.distributed, both
    processes on cuda:0 at test size: every group's rows and sketch
    blocks equal the CPU oracle's under the float rule, counters and
    freshness lags exactly, and both kernels launched in every host."""
    procs = th.spawn_distributed(tmp_path, device="cuda")
    oracle = th.run_oracle("cpu", with_rows=True)
    want = th.load_rows(oracle.pop("rows"))
    for pid, res in enumerate(procs):
        rows = th.load_rows(tmp_path / f"result.p{pid}.npz")
        for g, rec in res["groups"].items():
            assert rec["counters"] == oracle["groups"][g]["counters"]
            assert rec["fresh"] == oracle["groups"][g]["fresh"]
            th.check_rows_close(rows[int(g)]["docs"], want[int(g)]["docs"], f"group {g} docs")
            th.check_rows_close(rows[int(g)]["blocks"], want[int(g)]["blocks"],
                                f"group {g} blocks")
        assert res["launches"]["segreduce_gather"] > 0 and res["launches"]["sketch_fused"] > 0
        assert res["fetch"]["nonlocal"] == 0 and res["fetch"]["retraces"] == 0


@pytest.mark.cuda
def test_harness_child_reports_the_card(cuda, tmp_path):
    """A child asked for the card runs there: its name is the card's and
    its stash lives on CUDA."""
    spec = {"mode": "standalone", "num_processes": 1, "process_id": 0, "device": "cuda",
            "workdir": str(tmp_path), "out": str(tmp_path / "result.p0.json")}
    (res,) = th.spawn_hosts([spec])
    assert res["device"] == {"name": torch.cuda.get_device_name(0), "stash": ["cuda"]}
