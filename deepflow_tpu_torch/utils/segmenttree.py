"""Immutable interval index — the server/libs/segmenttree seat.

Port copy of deepflow_tpu/utils/segmenttree.py.

The reference builds an immutable segment tree over value ranges for
querier-side lookups (libs/segmenttree). The numpy-native equivalent is
a sorted-endpoint index answering the same queries without pointer
chasing, vectorized over query batches:

  * stab(points)   → which intervals contain each point
  * query(lo, hi)  → indices of intervals overlapping [lo, hi]

Build once (immutable), query many — the same usage contract.
"""

from __future__ import annotations

import numpy as np


class IntervalIndex:
    def __init__(self, starts, ends):
        """Intervals [starts[i], ends[i]] (inclusive), any order."""
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)
        if self.starts.shape != self.ends.shape:
            raise ValueError("starts/ends shape mismatch")
        if (self.ends < self.starts).any():
            raise ValueError("interval with end < start")
        self._by_start = np.argsort(self.starts, kind="stable")
        self._sorted_starts = self.starts[self._by_start]
        # running max of ends in start order: the classic augmented-tree
        # invariant flattened — intervals before position i can only
        # overlap x if max_end[:i] >= x
        self._max_end = (
            np.maximum.accumulate(self.ends[self._by_start])
            if len(self.starts)
            else np.empty(0, np.int64)
        )

    def __len__(self) -> int:
        return len(self.starts)

    def query(self, lo: int, hi: int) -> np.ndarray:
        """Indices (original order) of intervals overlapping [lo, hi]."""
        if not len(self):
            return np.empty(0, np.int64)
        # candidates: start <= hi
        k = int(np.searchsorted(self._sorted_starts, hi, side="right"))
        if k == 0:
            return np.empty(0, np.int64)
        cand = self._by_start[:k]
        hit = self.ends[cand] >= lo
        return np.sort(cand[hit])

    def stab(self, points) -> list[np.ndarray]:
        """For each point, the indices of intervals containing it."""
        return [self.query(int(p), int(p)) for p in np.asarray(points).ravel()]

    def coverage(self, points) -> np.ndarray:
        """[N] count of intervals containing each point (vectorized)."""
        pts = np.asarray(points, np.int64)
        if not len(self):
            return np.zeros(len(pts), np.int64)
        starts = np.sort(self.starts)
        ends = np.sort(self.ends)
        started = np.searchsorted(starts, pts, side="right")
        ended = np.searchsorted(ends, pts, side="left")
        return started - ended
