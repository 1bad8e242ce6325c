"""The frozen work counts against hand counts at one shape each."""

from __future__ import annotations

import pytest

from benchmark import work as W


def test_segreduce_bytes_by_hand():
    # 10 live rows of 2 meters read through the permutation: 10 x (8 + 4
    # id + 4 perm) = 160; 4 segment heads x 4 = 16; 3 live segments'
    # sums and maxima written: 3 x 2 x 2 x 4 = 48
    assert W.segreduce_bytes(10, 2, 4, 3) == 224
    assert W.segreduce_bytes(10, 2, 4, 3, gather=False) == 184
    assert W.segreduce_flops(10, 2) == 40


def test_sketch_fused_bytes_by_hand():
    # 10 live rows x 34 lane bytes = 340; (5 HLL + 7 count-min cells) x
    # (4 read + 4 written) = 96; challenger tables 2 x 4 x 8 x 21 = 1344
    assert W.sketch_fused_bytes(10, 4, 2, 8, 5, 7) == 1780


def test_least_seconds_takes_the_larger_bound():
    assert W.least_seconds(int(W.HBM_BYTES_PER_S)) == pytest.approx(1.0)
    assert W.least_seconds(0, int(2 * W.F32_FLOPS_PER_S)) == pytest.approx(2.0)
