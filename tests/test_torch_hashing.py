"""Port parity: packed tag words and murmur fingerprints.

The same seeded u32 columns go through the JAX package's
`pack_tag_words` / `fingerprint64*` and the port's (int64 u32 lanes on
the CPU); every word and every hash must be bit-equal, including
out-of-width values that land in the packing excess word."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.datamodel.code import (
    DOC_KEY_PACK,
    DOC_KEY_WIDTHS,
    RAW_TAG_PACK,
    RAW_TAG_WIDTHS,
    pack_tag_words as ref_pack_tag_words,
)
from deepflow_tpu.ops import hashing as ref_hashing
from deepflow_tpu_torch.datamodel.code import pack_tag_words
from deepflow_tpu_torch.ops import hashing
from deepflow_tpu_torch.ops.u32 import from_numpy_u32, mul, rotl, to_numpy_u32

# Each xdist worker imports every test module: one torch thread per
# worker keeps torch's CPU pool from oversubscribing the parallel suite
# (its timing-bound perf-gate tests share the cores).
torch.set_num_threads(1)

PLANS = {"raw": (RAW_TAG_PACK, RAW_TAG_WIDTHS), "doc": (DOC_KEY_PACK, DOC_KEY_WIDTHS)}
EXTREMES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32(rng, n, hi=1 << 32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _columns(widths, seed: int, in_width: bool, n: int = 257):
    rng = np.random.default_rng(seed)
    cols = {}
    for f, w in widths.items():
        c = _u32(rng, n, 1 << w if in_width else 1 << 32)
        c[: EXTREMES.size] = EXTREMES & np.uint32((1 << w) - 1 if in_width else 0xFFFFFFFF)
        cols[f] = c
    return cols


def _port(cols):
    return {k: from_numpy_u32(v, "cpu") for k, v in cols.items()}


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("in_width", [True, False], ids=["in_width", "excess"])
def test_pack_and_fingerprint_words_bit_equal(plan_name, in_width):
    plan, widths = PLANS[plan_name]
    cols = _columns(widths, seed=11, in_width=in_width)
    ref_words = ref_pack_tag_words({k: jnp.asarray(v) for k, v in cols.items()}, plan, jnp)
    words = pack_tag_words(_port(cols), plan)
    assert len(words) == len(ref_words) == plan.num_words
    for a, b in zip(ref_words, words):
        np.testing.assert_array_equal(np.asarray(a), to_numpy_u32(b))
    excess = to_numpy_u32(words[-1])
    if in_width:
        assert not excess.any()
    else:
        assert excess.any()
    ref_hi, ref_lo = ref_hashing.fingerprint64_words(ref_words)
    hi, lo = hashing.fingerprint64_words(words)
    np.testing.assert_array_equal(np.asarray(ref_hi), to_numpy_u32(hi))
    np.testing.assert_array_equal(np.asarray(ref_lo), to_numpy_u32(lo))


def test_fingerprint64_row_and_column_major_bit_equal():
    rng = np.random.default_rng(5)
    tags = _u32(rng, 300 * 9).reshape(300, 9)
    tags[: EXTREMES.size, 0] = EXTREMES
    ref = ref_hashing.fingerprint64(jnp.asarray(tags))
    got = hashing.fingerprint64(from_numpy_u32(tags, "cpu"))
    got_t = hashing.fingerprint64_t(from_numpy_u32(tags.T.copy(), "cpu"))
    for r, g, gt in zip(ref, got, got_t):
        np.testing.assert_array_equal(np.asarray(r), to_numpy_u32(g))
        np.testing.assert_array_equal(np.asarray(r), to_numpy_u32(gt))
    np.testing.assert_array_equal(
        np.asarray(ref_hashing.fmix32(jnp.asarray(tags[:, 3]))),
        to_numpy_u32(hashing.fmix32(from_numpy_u32(tags[:, 3], "cpu"))),
    )


@pytest.mark.parametrize("c", [5, 0xCC9E2D51, 0x1B873593, 0x85EBCA6B, 0xFFFFFFFF])
def test_u32_lane_multiply_and_rotate_wrap(c):
    """u32 × u32 never overflows int64 in the lane rule: the product
    matches numpy's wrapping uint32 multiply at the extremes."""
    rng = np.random.default_rng(c & 0xFFFF)
    x = np.concatenate([EXTREMES, _u32(rng, 64)])
    want = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
    got = to_numpy_u32(mul(from_numpy_u32(x, "cpu"), c))
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    r = (c % 31) + 1
    rot = ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)
    np.testing.assert_array_equal(to_numpy_u32(rotl(from_numpy_u32(x, "cpu"), r)), rot)
    assert from_numpy_u32(x, "cpu").dtype == torch.int64
