"""Port parity for the fused sketch update (ops/sketch_fused.py).

`sketch_update_fused_plain` — what the port runs on CPU tensors and the
CUDA kernel's parity reference on the card — against the reference's
two implementations of the same step on the same seeded, shared-sorted
phase lanes:

  * the Pallas kernel `sketch_update_fused` in interpret mode;
  * the XLA shared-sort branch (scatter-max, run-head scatter-add,
    `topk_challengers_presorted`).

hll, cms and the top-K lanes after `_apply_challengers` must be
bit-equal, on states that already hold data, over runs with weight ties
between colliding keys, zero weights, masked rows and weights ≥ 2^31
(saturated to INT_MAX, their run sums wrapping). The CUDA launch itself
is checked on the card (chip_smoke.py and tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.ops import sketch_pallas as ref_pallas
from deepflow_tpu.ops import topk as ref_topk
from deepflow_tpu.ops.cms import row_slots as ref_row_slots
from deepflow_tpu_torch.ops import sketch_fused, topk
from deepflow_tpu_torch.ops.histogram import saturate_i32
from deepflow_tpu_torch.ops.segment import sort_perm
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

torch.set_num_threads(1)

SHAPES = dict(ring=4, g=4, m=64, d_cms=3, w_cms=128, d_tk=2, c_tk=8)


def _phase_lanes(seed: int, n: int, huge: bool):
    """Seeded lanes of one phase: few distinct keys (long runs), keys
    colliding in the small top-K table with tied run weights, zero
    weights, ~15% masked rows. Returns (sorted, port): the reference's
    lanes in the shared (window, hi, lo) order (each batch lane fed as
    lane[s_pos]), and the port's keywords — the batch-order lanes, s_pos
    and the sorted lanes — as numpy."""
    rng = np.random.default_rng(seed)
    win = rng.integers(100, 104, n).astype(np.uint32)
    kid = rng.integers(0, 24, n)
    hi = (kid * 2654435761 + 7).astype(np.uint32)
    lo = (kid * 40503 ^ 0x9E3779B9).astype(np.uint32)
    weight = rng.choice([0.0, 5.0, 5.0, 100.0, 7.0], n).astype(np.float32)
    if huge:
        weight[rng.random(n) < 0.2] = 3e9  # saturates to INT_MAX
    mask = rng.random(n) > 0.15
    client_hi, client_lo = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
                            for _ in range(2))
    gid = rng.integers(0, SHAPES["g"], n).astype(np.int64)
    id_a = (kid + 1000).astype(np.uint32)
    id_b = ((443 << 16) | 6) * np.ones(n, np.uint32)
    m = SHAPES["m"]
    reg = (client_lo & (m - 1)).astype(np.int64)
    rho = np.asarray([33 - int(x).bit_length() if x else 33 for x in client_hi], np.int64)

    perm = sort_perm(*(from_numpy_u32(x, "cpu") for x in (win, hi, lo))).numpy()
    s = {k: v[perm] for k, v in dict(win=win, hi=hi, lo=lo).items()}
    w = np.where(mask, saturate_i32(torch.from_numpy(weight)).numpy(), 0)[perm]
    head = np.r_[True, (s["win"][1:] != s["win"][:-1]) | (s["hi"][1:] != s["hi"][:-1])
                 | (s["lo"][1:] != s["lo"][:-1])][:n]
    run_id = np.cumsum(head) - 1
    run_w = np.zeros(n, np.int64)
    np.add.at(run_w, run_id, w.astype(np.int64))
    rw = ((run_w[run_id] + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)  # int32 wrap
    ref = dict(
        s_slot=(s["win"] % SHAPES["ring"]).astype(np.int64), s_gid=gid[perm],
        s_reg=reg[perm], s_rho=rho[perm], s_mask=mask[perm],
        w_head=np.where(head, rw, 0).astype(np.int32), rw=rw, s_hi=s["hi"], s_lo=s["lo"],
        s_ia=id_a[perm], s_ib=id_b[perm],
    )
    port = dict(gid=gid, reg=reg, rho=rho, mask=mask, id_a=id_a, id_b=id_b,
                s_pos=perm.astype(np.int64), s_win=s["win"], head=head, rw=rw,
                s_hi=s["hi"], s_lo=s["lo"])
    return ref, port


def _state(seed: int, filled: bool):
    rng = np.random.default_rng(seed + 99)
    r, g, m = SHAPES["ring"], SHAPES["g"], SHAPES["m"]
    d, w, dt, c = SHAPES["d_cms"], SHAPES["w_cms"], SHAPES["d_tk"], SHAPES["c_tk"]
    hll = rng.integers(0, 20, (r, g, m)) if filled else np.zeros((r, g, m))
    cms = rng.integers(0, 5000, (r, d, w)) if filled else np.zeros((r, d, w))
    votes = rng.integers(0, 300, (r, dt, c)) if filled else np.zeros((r, dt, c))
    keys = [rng.integers(0, 2 ** 32, (r, dt, c), dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    if filled:  # some buckets already hold keys the batch will match
        lanes, _ = _phase_lanes(seed, 64, False)
        keys[0][0, 0, :4] = lanes["s_hi"][:4]
        keys[1][0, 0, :4] = lanes["s_lo"][:4]
    return hll.astype(np.int32), cms.astype(np.int32), [votes.astype(np.int32)] + keys


def _reference(hll, cms, lanes, x, *, pallas: bool):
    """The reference's applied step: Pallas (interpret) or XLA branch."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    d, w = SHAPES["d_cms"], SHAPES["w_cms"]
    rs = ref_row_slots(j["s_hi"], j["s_lo"], d, w)
    hll_j, cms_j = jnp.asarray(hll), jnp.asarray(cms)
    if pallas:
        hll_j, cms_j, ch = ref_pallas.sketch_update_fused(
            hll_j, cms_j, tk_shape=(SHAPES["d_tk"], SHAPES["c_tk"]),
            s_slot=j["s_slot"].astype(jnp.int32), s_gid=j["s_gid"], s_reg=j["s_reg"],
            s_rho=j["s_rho"], s_mask=j["s_mask"], w_head=j["w_head"], rw=j["rw"],
            cms_slots=rs, s_hi=j["s_hi"], s_lo=j["s_lo"], s_ia=j["s_ia"], s_ib=j["s_ib"])
    else:
        r, g, m = hll.shape
        slot = j["s_slot"].astype(jnp.int32)
        gslot = jnp.where(j["s_mask"], slot, r)
        hll_j = hll_j.at[gslot, j["s_gid"], j["s_reg"]].max(
            j["s_rho"].astype(jnp.int32), mode="drop")
        flat = slot[None, :] * (d * w) + rs
        cms_j = (cms_j.reshape(-1).at[flat.reshape(-1)]
                 .add(jnp.broadcast_to(j["w_head"][None, :], flat.shape).reshape(-1),
                      mode="drop").reshape(cms.shape))
        ch = ref_topk.topk_challengers_presorted(
            slot, j["s_hi"], j["s_lo"], j["s_ia"], j["s_ib"], j["rw"], j["s_mask"],
            r, SHAPES["d_tk"], SHAPES["c_tk"])
    out = ref_topk._apply_challengers(tuple(jnp.asarray(v) for v in lanes), ch)
    return np.asarray(hll_j), np.asarray(cms_j), [np.asarray(v) for v in out]


def _port(hll, cms, lanes, x):
    t = {k: (from_numpy_u32(v, "cpu") if k in ("id_a", "id_b", "s_win", "s_hi", "s_lo")
             else torch.from_numpy(np.ascontiguousarray(v))) for k, v in x.items()}
    hll_t, cms_t = torch.from_numpy(hll.copy()), torch.from_numpy(cms.copy())
    hll_t, cms_t, ch = sketch_fused.sketch_update_fused(
        hll_t, cms_t, tk_shape=(SHAPES["d_tk"], SHAPES["c_tk"]), **t)
    port_lanes = tuple(torch.from_numpy(np.ascontiguousarray(v).view(np.int32)) for v in lanes)
    out = topk._apply_challengers(port_lanes, ch)
    return hll_t.numpy(), cms_t.numpy(), [v.numpy() for v in out]


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas_interpret", "xla_presorted"])
@pytest.mark.parametrize("seed,n,huge,filled", [(11, 256, False, False), (12, 384, True, True),
                                                (13, 200, True, False), (14, 512, False, True),
                                                (15, 1, False, True), (16, 333, True, True)])
def test_plain_matches_reference(pallas, seed, n, huge, filled):
    """The port takes the batch-order lanes and s_pos; the reference is
    fed lane[s_pos]."""
    x, port = _phase_lanes(seed, n, huge)
    hll, cms, lanes = _state(seed, filled)
    want = _reference(hll, cms, lanes, x, pallas=pallas)
    got = _port(hll, cms, lanes, port)
    np.testing.assert_array_equal(want[0], got[0], err_msg="hll")
    np.testing.assert_array_equal(want[1], got[1], err_msg="cms")
    for name, a, b in zip(("votes", "hi", "lo", "ia", "ib"), want[2], got[2]):
        np.testing.assert_array_equal(a.view(np.int32), b, err_msg=name)
    if n > 1:
        assert (got[0] != hll).any() and (got[1] != cms).any()
    if huge:  # a saturated weight's run wrapped: the case the cast pins
        assert (x["rw"] < 0).any() or (x["rw"] == 2 ** 31 - 1).any()


def test_plain_raw_challengers_match_xla_branch():
    """Before the epilogue: the plain version's challenger tables are the
    XLA branch's, lane for lane (got and hw everywhere, the key/id lanes
    where got)."""
    x, _ = _phase_lanes(21, 300, True)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = ref_topk.topk_challengers_presorted(
        j["s_slot"].astype(jnp.int32), j["s_hi"], j["s_lo"], j["s_ia"], j["s_ib"], j["rw"],
        j["s_mask"], SHAPES["ring"], SHAPES["d_tk"], SHAPES["c_tk"])
    t = {k: from_numpy_u32(x[k], "cpu") for k in ("s_hi", "s_lo", "s_ia", "s_ib")}
    got = topk.topk_challengers_presorted(
        torch.from_numpy(x["s_slot"]), t["s_hi"], t["s_lo"], t["s_ia"], t["s_ib"],
        torch.from_numpy(x["rw"]), torch.from_numpy(x["s_mask"]), SHAPES["ring"],
        SHAPES["d_tk"], SHAPES["c_tk"])
    for (w_got, *w_lanes, w_hw), (g_got, *g_lanes, g_hw) in zip(want, got):
        got_np = np.asarray(w_got)
        np.testing.assert_array_equal(got_np, g_got.numpy())
        np.testing.assert_array_equal(np.asarray(w_hw), g_hw.numpy())
        for a, b in zip(w_lanes, g_lanes):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32)[got_np],
                                          b.numpy()[got_np])


def test_wrapper_counts_no_launch_on_cpu():
    """CPU tensors take the plain version: no kernel, no launch count."""
    sketch_fused.reset_launch_counts()
    _, x = _phase_lanes(31, 64, False)
    hll, cms, lanes = _state(31, False)
    _port(hll, cms, lanes, x)
    assert sketch_fused.LAUNCHES == {"sketch_fused": 0}
