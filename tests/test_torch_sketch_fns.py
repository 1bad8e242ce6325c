"""Port parity for the standalone sketch functions and the multi-sort
oracle.

Every function of deepflow_tpu_torch/ops/{hll,cms,histogram,tdigest,
topk}.py that the reference exposes as a one-sketch function (init,
update, merge, estimate / query / quantiles, `tdigest_from_loghist`,
`tdigest_merge`, `topk_init` / `topk_update`) runs on the cases of
tests/test_sketches.py: the same seeded numpy inputs go through the JAX
function (CPU backend) and the port's (CPU tensors). Integer lanes are
bit-equal; float results (HLL estimates, histogram quantiles, t-digest
centroids and quantiles) within rtol 1e-5 (float32 sums in another
order). Then the sketch plane with DEEPFLOW_SHARED_SORT=0 — the
reference's multi-sort oracle — against the reference's oracle and
against the port's shared sort, slab and pooled.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import sketchplane as ref_sp
from deepflow_tpu.ops import cms as ref_cms
from deepflow_tpu.ops import histogram as ref_hist
from deepflow_tpu.ops import hll as ref_hll
from deepflow_tpu.ops import tdigest as ref_td
from deepflow_tpu.ops import topk as ref_topk
from deepflow_tpu.ops.hashing import fingerprint64
from deepflow_tpu_torch.aggregator import sketchplane
from deepflow_tpu_torch.ops import cms, histogram, hll, tdigest, topk
from deepflow_tpu_torch.ops.segment import sort_census
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

import test_torch_sketch_plane as slab_cases
import test_torch_sketch_pool as pool_cases

torch.set_num_threads(1)

FLOAT_RTOL = 1e-5


def _lane(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _hashes(n, seed, card):
    """tests/test_sketches.py::_hashes: n draws from `card` ids,
    fingerprinted by the reference's murmur (host arrays)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, card, size=(n, 1), dtype=np.uint32)
    hi, lo = fingerprint64(jnp.asarray(ids))
    return ids[:, 0], np.asarray(hi), np.asarray(lo)


# ---------------------------------------------------------------------------
# HLL: tests/test_sketches.py TestHLL cases + the production precision


@pytest.mark.parametrize("groups,precision,n,card,seed", [
    (4, 14, 200_000, 100_000, 3),   # test_accuracy_1pct (the production width)
    (1, 12, 500, 300, 4),           # small range: the linear-counting branch
    (2, 12, 2000, 1000, 7),         # group isolation
    (2, 10, 3000, 2500, 24),        # merge algebra
], ids=["p14", "linear", "groups", "merge"])
def test_hll_functions_bit_equal(groups, precision, n, card, seed):
    _, hi, lo = _hashes(n, seed, card)
    rng = np.random.default_rng(seed + 100)
    gids = (np.arange(n) % groups).astype(np.int32)
    valid = rng.random(n) > 0.05
    want = ref_hll.hll_update(ref_hll.hll_init(groups, precision), jnp.asarray(gids),
                              jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    got = hll.hll_update(hll.hll_init(groups, precision, device="cpu"),
                         torch.from_numpy(gids), _lane(hi), _lane(lo), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_allclose(hll.hll_estimate(got).numpy(),
                               np.asarray(ref_hll.hll_estimate(want)), rtol=FLOAT_RTOL)
    # merge: the union of a second stream
    _, hi2, lo2 = _hashes(n, seed + 1, card)
    want2 = ref_hll.hll_update(ref_hll.hll_init(groups, precision), jnp.asarray(gids),
                               jnp.asarray(hi2), jnp.asarray(lo2), jnp.ones(n, bool))
    got2 = hll.hll_update(hll.hll_init(groups, precision, device="cpu"),
                          torch.from_numpy(gids), _lane(hi2), _lane(lo2),
                          torch.ones(n, dtype=torch.bool))
    np.testing.assert_array_equal(np.asarray(ref_hll.hll_merge(want, want2)),
                                  hll.hll_merge(got, got2).numpy())


# ---------------------------------------------------------------------------
# count-min: TestCMS + merge algebra cases + the production plane 4 × 2^16


@pytest.mark.parametrize("depth,width,n,seed", [
    (4, 1 << 14, 50_000, 8),    # point queries, Zipf keys
    (3, 1 << 10, 4000, 20),     # merge algebra, weighted
    (4, 1 << 16, 20_000, 5),    # the production plane
], ids=["zipf", "weighted", "production"])
def test_cms_functions_bit_equal(depth, width, n, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, size=n) % 1000).astype(np.uint32)
    hi, lo = (np.asarray(x) for x in fingerprint64(jnp.asarray(keys[:, None])))
    weight = rng.integers(1, 50, n).astype(np.int32)
    valid = rng.random(n) > 0.05
    states = []
    for w in (weight, np.ones(n, np.int32)):
        want = ref_cms.cms_update(ref_cms.cms_init(depth, width), jnp.asarray(hi),
                                  jnp.asarray(lo), jnp.asarray(w), jnp.asarray(valid))
        got = cms.cms_update(cms.cms_init(depth, width, device="cpu"), _lane(hi), _lane(lo),
                             torch.from_numpy(w), torch.from_numpy(valid))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        states.append((want, got))
    (wa, ga), (wb, gb) = states
    np.testing.assert_array_equal(np.asarray(ref_cms.cms_merge(wa, wb)),
                                  cms.cms_merge(ga, gb).numpy())
    uniq = np.unique(keys)
    uh, ul = (np.asarray(x) for x in fingerprint64(jnp.asarray(uniq[:, None])))
    want_q = np.asarray(ref_cms.cms_query(ref_cms.cms_merge(wa, wb), jnp.asarray(uh),
                                          jnp.asarray(ul)))
    got_q = cms.cms_query(cms.cms_merge(ga, gb), _lane(uh), _lane(ul)).numpy()
    np.testing.assert_array_equal(want_q, got_q)


# ---------------------------------------------------------------------------
# log histograms: TestLogHist + merge algebra


@pytest.mark.parametrize("spec,dist,n,seed", [
    ((1024, 1.0, 1.02), "lognormal", 100_000, 9),
    ((128, 1.0, 1.1), "uniform", 2000, 29),
], ids=["lognormal", "uniform"])
def test_loghist_functions_bit_equal(spec, dist, n, seed):
    bins, vmin, gamma = spec
    r_spec = ref_hist.LogHistSpec(bins=bins, vmin=vmin, gamma=gamma)
    p_spec = histogram.LogHistSpec(bins=bins, vmin=vmin, gamma=gamma)
    rng = np.random.default_rng(seed)
    states = []
    for part in range(2):
        vals = (rng.lognormal(6.0, 1.5, n) if dist == "lognormal"
                else rng.uniform(1, 500, n)).astype(np.float32)
        gids = rng.integers(0, 3, n).astype(np.int32)
        valid = rng.random(n) > 0.05
        want = ref_hist.loghist_update(ref_hist.loghist_init(3, r_spec), jnp.asarray(gids),
                                       jnp.asarray(vals), jnp.asarray(valid), r_spec)
        got = histogram.loghist_update(histogram.loghist_init(3, p_spec, device="cpu"),
                                       torch.from_numpy(gids), torch.from_numpy(vals),
                                       torch.from_numpy(valid), p_spec)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        states.append((want, got))
    (wa, ga), (wb, gb) = states
    want_m, got_m = ref_hist.loghist_merge(wa, wb), histogram.loghist_merge(ga, gb)
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    empty = np.zeros((1, bins), np.int32)  # an empty group reads 0
    qs = (0.0, 0.5, 0.95, 0.99, 1.0)
    for w_state, g_state in ((want_m, got_m), (jnp.asarray(empty), torch.from_numpy(empty))):
        want_q = np.asarray(ref_hist.loghist_quantiles(w_state, r_spec, qs))
        got_q = histogram.loghist_quantiles(g_state, p_spec, qs).numpy()
        np.testing.assert_allclose(got_q, want_q, rtol=FLOAT_RTOL)
        # the bin each quantile reads (the searchsorted side) is the same
        centers = histogram.loghist_centers(p_spec).numpy()
        live = want_q > 0
        np.testing.assert_array_equal(
            np.abs(want_q[..., None] - centers).argmin(-1)[live],
            np.abs(got_q[..., None] - centers).argmin(-1)[live])


# ---------------------------------------------------------------------------
# t-digest: TestTDigest + merge algebra


def test_tdigest_functions_within_rtol():
    spec_args = dict(bins=1024, vmin=1.0, gamma=1.02)
    r_spec, p_spec = ref_hist.LogHistSpec(**spec_args), histogram.LogHistSpec(**spec_args)
    rng = np.random.default_rng(12)
    vals = rng.lognormal(5.0, 1.0, 50_000).astype(np.float32)
    hist = np.zeros((3, 1024), np.int32)
    np.add.at(hist[0], np.asarray(ref_hist.loghist_bin(jnp.asarray(vals), r_spec)), 1)
    hist[2, 7] = 9  # a point mass; group 1 stays empty
    want_m, want_w = ref_td.tdigest_from_loghist(jnp.asarray(hist), r_spec, compression=64)
    got_m, got_w = tdigest.tdigest_from_loghist(torch.from_numpy(hist), p_spec, compression=64)
    assert got_m.shape == (3, 64)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=FLOAT_RTOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=FLOAT_RTOL)
    assert float(got_w[1].sum()) == 0.0
    qs = np.array([0.0, 0.01, 0.5, 0.9, 0.99, 1.0], np.float32)
    for g in range(3):
        want_q = np.asarray(ref_td.tdigest_quantile(want_m[g], want_w[g], jnp.asarray(qs)))
        got_q = tdigest.tdigest_quantile(got_m[g], got_w[g], torch.from_numpy(qs))
        assert isinstance(got_q, torch.Tensor)
        np.testing.assert_allclose(got_q.numpy(), want_q, rtol=FLOAT_RTOL)
    # raw-value digests and their merge (test_merge_two_digests)
    digests = []
    for mu, sd in ((1000, 100), (2000, 100)):
        v = rng.normal(mu, sd, 10_000).astype(np.float32)
        w = np.ones(v.shape, np.float32)
        ref_d = ref_td.tdigest_compress(jnp.asarray(v), jnp.asarray(w), compression=100)
        got_d = tdigest.tdigest_compress(torch.from_numpy(v), torch.from_numpy(w),
                                         compression=100)
        np.testing.assert_allclose(got_d[0].numpy(), np.asarray(ref_d[0]), rtol=FLOAT_RTOL)
        np.testing.assert_allclose(got_d[1].numpy(), np.asarray(ref_d[1]), rtol=FLOAT_RTOL)
        digests.append((ref_d, got_d))
    (ra, ga), (rb, gb) = digests
    want_m, want_w = ref_td.tdigest_merge(*ra, *rb, compression=100)
    got_m, got_w = tdigest.tdigest_merge(*ga, *gb, compression=100)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=FLOAT_RTOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=FLOAT_RTOL)
    want_q = np.asarray(ref_td.tdigest_quantile(want_m, want_w, jnp.asarray(qs)))
    np.testing.assert_allclose(tdigest.tdigest_quantile(got_m, got_w, torch.from_numpy(qs))
                               .numpy(), want_q, rtol=FLOAT_RTOL)
    # host arrays (a fetched block's) go in as CPU tensors
    np.testing.assert_allclose(tdigest.tdigest_quantile(got_m.numpy(), got_w.numpy(), qs),
                               want_q, rtol=FLOAT_RTOL)


# ---------------------------------------------------------------------------
# top-K: topk_init + the multi-sort topk_update


_ref_topk_update = jax.jit(ref_topk.topk_update)


def _topk_batch(rng, n, keys, ring):
    kid = rng.zipf(1.4, n) % keys
    u32 = lambda size: rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    slot = rng.integers(-1, ring + 1, n).astype(np.int32)  # some outside [0, R)
    return dict(slot=slot, key_hi=(kid * 2654435761 + 1).astype(np.uint32),
                key_lo=(kid ^ 0x9E3779B9).astype(np.uint32), id_a=kid.astype(np.uint32),
                id_b=u32(n), weight=rng.integers(0, 900, n).astype(np.int32),
                valid=rng.random(n) > 0.1)


@pytest.mark.parametrize("rows,cols,ring", [(2, 64, 3), (4, 1024, 1)], ids=["ring", "one"])
def test_topk_update_oracle_bit_equal(rows, cols, ring):
    rng = np.random.default_rng(rows * cols + ring)
    r_lanes = ref_topk.topk_init(rows, cols, ring)
    lanes = topk.topk_init(rows, cols, ring, device="cpu")
    assert all(x.dtype == torch.int32 and x.shape == (ring, rows, cols) for x in lanes)
    u32 = ("key_hi", "key_lo", "id_a", "id_b")
    for _ in range(3):  # three batches: challengers meet occupied buckets
        b = _topk_batch(rng, 3000, 200, ring)
        r_lanes = _ref_topk_update(r_lanes, *(jnp.asarray(b[k]) for k in (
            "slot", "key_hi", "key_lo", "id_a", "id_b", "weight", "valid")))
        t = {k: (_lane(v) if k in u32 else torch.from_numpy(v)) for k, v in b.items()}
        with sort_census() as tally:
            lanes = topk.topk_update(lanes, t["slot"], t["key_hi"], t["key_lo"], t["id_a"],
                                     t["id_b"], t["weight"], t["valid"])
        assert tally["sorts"] == rows  # one logical sort per hash row
        for want, got in zip(r_lanes, lanes):
            np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy())
    assert int((lanes[0] > 0).sum()) > 0


# ---------------------------------------------------------------------------
# the plane with DEEPFLOW_SHARED_SORT=0: against the reference's oracle
# and against the port's shared sort


U32_KEYS = pool_cases.U32_KEYS
# one compile per plane shape and path instead of an eager dispatch per op
_ref_step = jax.jit(ref_sp.sketch_plane_step, static_argnums=(1,),
                    static_argnames=("shared_sort", "fused_sketch"))


def _port_step(sk, cfg, x, base_w, close_w, shared):
    t = {k: (_lane(v) if k in U32_KEYS else torch.from_numpy(v)) for k, v in x.items()}
    with sort_census() as tally:
        sk = sketchplane.sketch_plane_step(sk, cfg.hist, base_w=base_w, close_w=close_w,
                                           shared_sort=shared, **t)
    return sk, tally


@pytest.mark.parametrize("mode,topk_rows", [("slab", 2), ("pool", 2), ("slab", 0)],
                         ids=["slab", "pool", "no_topk"])
def test_plane_oracle_bit_equal(mode, topk_rows):
    """Each step's plane state: the port's oracle equals the reference's
    oracle, and the port's shared sort the reference's shared sort. In
    slab mode the two paths are also equal to each other (the
    reference's own pin, tests/test_sketch_onepass.py); in pool mode the
    reference's two paths differ in count-min on this stream, and the
    port follows each."""
    if mode == "slab":
        ref_cfg, cfg = slab_cases._configs(topk_rows=topk_rows)
        stream = slab_cases._plane_stream(40 + topk_rows)
    else:
        ref_cfg, cfg = pool_cases._configs(topk_rows=topk_rows)
        stream = pool_cases._pool_stream(9)
    r_or = r_sh = ref_sp.sketch_init(ref_cfg, 4)
    oracle = sketchplane.sketch_init(cfg, 4, device="cpu")
    shared = sketchplane.sketch_init(cfg, 4, device="cpu")
    for x, base_w, close_w in stream:
        kw = dict(base_w=jnp.uint32(base_w), close_w=jnp.uint32(close_w), fused_sketch=False,
                  **{k: jnp.asarray(v) for k, v in x.items()})
        r_or = _ref_step(r_or, ref_cfg.hist, shared_sort=False, **kw)
        oracle, t_or = _port_step(oracle, cfg, x, base_w, close_w, False)
        shared, t_sh = _port_step(shared, cfg, x, base_w, close_w, True)
        slab_cases._assert_plane_equal(r_or, oracle)
        if mode == "slab":
            slab_cases._assert_plane_equal(r_or, shared)
        else:
            r_sh = _ref_step(r_sh, ref_cfg.hist, shared_sort=True, **kw)
            slab_cases._assert_plane_equal(r_sh, shared)
        # the plane's sorts (tests/test_sketch_onepass.py:167-183): 2
        # phases × topk_rows, twice over in pool mode (one topk_update
        # per arena, as in the reference)
        assert t_or["plane_sorts"] == 2 * topk_rows * (2 if mode == "pool" else 1)
        assert t_sh["plane_sorts"] == (1 if topk_rows else 0)
    assert int(oracle.rows) > 0
