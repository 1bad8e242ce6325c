"""Port parity: the segmented SUM/MAX reduce.

The port's plain PyTorch version (what a CPU tensor runs, and the CUDA
kernel's parity reference on the card) against the JAX package's Pallas
`sorted_segment_sum_max`, run in interpret mode as
tests/test_segreduce_pallas.py runs it, on the same CASES, with and
without the gather permutation. Integer rows are exact; float rows take
rtol 1e-5 on sums (summation order) and exact maxs. Only live segments
compare: absent ones hold garbage by contract."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.ops.segreduce_pallas import sorted_segment_sum_max as ref_sum_max
from deepflow_tpu_torch.ops.segreduce import (
    LANES,
    sorted_segment_sum_max,
    sorted_segment_sum_max_plain,
)

# Each xdist worker imports every test module: one torch thread per
# worker keeps torch's CPU pool from oversubscribing the parallel suite
# (its timing-bound perf-gate tests share the cores).
torch.set_num_threads(1)

CASES = [
    (1024, 256, 100, 256),     # multi-block, segments span blocks
    (1024, 256, 3, 128),       # few huge segments (span many blocks)
    (777, 64, 40, 256),        # non-multiple-of-block row count
    (2048, 2048, 1500, 512),   # cap == n-scale, many singletons
    (512, 32, 1, 128),         # one segment spanning everything
]


def _case(n, cap, n_keys, m=7, seed=0, integral=True, block=256, fused=False):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n_keys, n)).astype(np.int32)
    n_live = n - n // 8  # tail of dead rows, ids past every live one
    seg[n_live:] = n
    if integral:
        rows = rng.integers(0, 1000, (n, m)).astype(np.float32)
    else:
        rows = rng.standard_normal((n, m)).astype(np.float32) * 1e3
    first_pos = np.searchsorted(seg, np.arange(cap)).astype(np.int32)
    perm = None
    if fused:
        perm = rng.permutation(n).astype(np.int32)
        rows_orig = np.empty_like(rows)
        rows_orig[perm] = rows
        rows = rows_orig
    ref = ref_sum_max(
        jnp.asarray(rows), jnp.asarray(seg), cap, jnp.asarray(first_pos),
        perm=None if perm is None else jnp.asarray(perm), block=block,
    )
    got = sorted_segment_sum_max_plain(
        torch.from_numpy(rows), torch.from_numpy(seg), cap,
        torch.from_numpy(first_pos),
        perm=None if perm is None else torch.from_numpy(perm),
    )
    live_ids = np.unique(seg[:n_live])
    live = np.zeros(cap, bool)
    live[live_ids[live_ids < cap]] = True
    return ([np.asarray(r)[live] for r in ref], [g.numpy()[live] for g in got])


@pytest.mark.parametrize("n,cap,n_keys,block", CASES)
@pytest.mark.parametrize("fused", [False, True], ids=["pregather", "fused"])
def test_plain_matches_pallas_integral(n, cap, n_keys, block, fused):
    (rs, rm), (gs, gm) = _case(n, cap, n_keys, block=block, fused=fused)
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_array_equal(gm, rm)


@pytest.mark.parametrize("fused", [False, True], ids=["pregather", "fused"])
def test_plain_matches_pallas_float_tolerance(fused):
    (rs, rm), (gs, gm) = _case(1024, 256, 50, integral=False, seed=3, fused=fused)
    np.testing.assert_allclose(gs, rs, rtol=1e-5)
    np.testing.assert_array_equal(gm, rm)  # max is order-free → exact


def test_cpu_wrapper_takes_the_plain_version():
    """On a CPU tensor the wrapper is the plain version, bit for bit."""
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.standard_normal((300, 62)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, 300)).astype(np.int32))
    fp = torch.searchsorted(seg, torch.arange(32, dtype=torch.int32), out_int32=True)
    perm = torch.from_numpy(rng.permutation(300).astype(np.int32))
    for p in (None, perm):
        a = sorted_segment_sum_max(rows, seg, 32, fp, perm=p)
        b = sorted_segment_sum_max_plain(rows, seg, 32, fp, perm=p)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("fn", [sorted_segment_sum_max, sorted_segment_sum_max_plain])
def test_meter_width_guard(fn):
    """A meter row wider than the kernel's 128 columns fails loudly."""
    with pytest.raises(ValueError, match="lanes"):
        fn(torch.zeros((16, LANES + 1)), torch.zeros(16, dtype=torch.int32), 4,
           torch.zeros(4, dtype=torch.int32))
