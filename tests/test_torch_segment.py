"""Port parity: `groupby_reduce` gives a bit-equal `Grouped`.

Duplicate keys carry differing non-key tags, so the kept representative
row pins the stable tie-break of the sort (the lowest original row
wins); overflow (`num_segments > cap`), an all-invalid batch and keys
at the top of the u32 range (unsigned ordering, the sentinel slot) are
covered. Both gather variants (DEEPFLOW_FUSED_GATHER) run the port."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.ops.segment import groupby_reduce as ref_groupby_reduce
from deepflow_tpu_torch.ops.segment import groupby_reduce
from deepflow_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# Each xdist worker imports every test module: one torch thread per
# worker keeps torch's CPU pool from oversubscribing the parallel suite
# (its timing-bound perf-gate tests share the cores).
torch.set_num_threads(1)

SUM_COLS = np.array([0, 1, 2, 3], np.int32)
MAX_COLS = np.array([4, 5], np.int32)


def _inputs(seed: int, n: int, all_invalid: bool = False, high_keys: bool = False):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, 3, n).astype(np.uint32)
    hi = rng.integers(0, 50, n).astype(np.uint32)
    lo = rng.integers(0, 2, n).astype(np.uint32)
    if high_keys:
        # the top of the u32 range must order as unsigned, and a live
        # slot just below the sentinel stays live
        slot = rng.choice(np.array([0, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE],
                                   np.uint32), n)
        hi = rng.choice(np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32), n)
        lo = rng.choice(np.array([0, 0xFFFFFFFF], np.uint32), n)
    tags = rng.integers(0, 100, (5, n)).astype(np.uint32)  # non-key payload
    meters = rng.integers(0, 500, (n, 6)).astype(np.float32)
    valid = rng.random(n) < 0.9
    if all_invalid:
        valid[:] = False
    return slot, hi, lo, tags, meters, valid


def _compare(inputs, cap):
    slot, hi, lo, tags, meters, valid = inputs
    ref = ref_groupby_reduce(
        jnp.asarray(slot), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(tags),
        jnp.asarray(meters), jnp.asarray(valid), SUM_COLS, MAX_COLS,
        out_capacity=cap,
    )
    got = groupby_reduce(
        from_numpy_u32(slot, "cpu"), from_numpy_u32(hi, "cpu"),
        from_numpy_u32(lo, "cpu"), from_numpy_u32(tags, "cpu"),
        torch.from_numpy(meters), torch.from_numpy(valid), SUM_COLS, MAX_COLS,
        out_capacity=cap,
    )
    for lane in ("slot", "key_hi", "key_lo", "tags"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, lane)), to_numpy_u32(getattr(got, lane)), err_msg=lane
        )
    np.testing.assert_array_equal(
        np.asarray(ref.meters).view(np.uint32), got.meters.numpy().view(np.uint32)
    )
    np.testing.assert_array_equal(np.asarray(ref.seg_valid), got.seg_valid.numpy())
    assert int(ref.num_segments) == int(got.num_segments)
    return int(got.num_segments)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "pregather"])
@pytest.mark.parametrize(
    "seed,n,cap,kind",
    [
        (7, 512, 512, "plain"),        # every segment fits
        (8, 512, 64, "overflow"),      # num_segments > cap
        (9, 256, 128, "all_invalid"),
        (10, 384, 384, "high_keys"),
    ],
)
def test_groupby_reduce_bit_equal(monkeypatch, fused, seed, n, cap, kind):
    monkeypatch.setenv("DEEPFLOW_FUSED_GATHER", fused)
    nseg = _compare(
        _inputs(seed, n, all_invalid=kind == "all_invalid",
                high_keys=kind == "high_keys"),
        cap,
    )
    if kind == "overflow":
        assert nseg > cap
    if kind == "all_invalid":
        assert nseg == 0


def test_duplicate_keys_keep_the_first_rows_tags():
    """Every row shares one key; the Grouped tags must be row 0's."""
    n = 64
    slot = np.zeros(n, np.uint32)
    hi = np.full(n, 7, np.uint32)
    lo = np.full(n, 3, np.uint32)
    tags = np.arange(5 * n, dtype=np.uint32).reshape(5, n)[:, ::-1].copy()
    meters = np.ones((n, 6), np.float32)
    valid = np.ones(n, bool)
    assert _compare((slot, hi, lo, tags, meters, valid), 4) == 1
