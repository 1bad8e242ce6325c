"""Possible-host activity map — the utils/possible_host.rs seat.

Port copy of deepflow_tpu/agent/possible.py.

The reference keeps an LRU of hosts recently seen ORIGINATING traffic
(PossibleHost, capacity-bounded) and consults it when deciding
`is_active_host` for endpoints that platform data doesn't know —
inactive endpoints get their IPs zeroed/aggregated in the doc fanout
(collector.rs get_single_tagger inactive handling). Scalar LRU probing
doesn't vectorize, so this build uses a fixed open-addressing table of
hashed-ip slots with epoch stamps: batch add + batch membership are a
handful of numpy gathers, and aging is free (a slot is live iff its
stamp is within the lease).

Collisions can only FALSELY mark a host active (shared slot), never
inactive — the same failure direction as the reference's LRU dropping
old entries, and harmless: activity is an aggregation hint, not a
correctness bit.
"""

from __future__ import annotations

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)


def _hash_ips(ip_words: np.ndarray) -> np.ndarray:
    """[N, 4] u32 ip words → [N] u64 keys (splitmix-style fold)."""
    h = np.zeros(ip_words.shape[0], np.uint64)
    for w in range(ip_words.shape[1]):
        h = (h ^ ip_words[:, w].astype(np.uint64)) * _MIX
        h ^= h >> np.uint64(29)
    return h


class PossibleHostTable:
    def __init__(self, *, capacity_pow: int = 18, probes: int = 2,
                 lease_s: int = 300):
        self.mask = (1 << capacity_pow) - 1
        self.probes = probes
        self.lease_s = lease_s
        self.keys = np.zeros(1 << capacity_pow, np.uint64)
        self.stamp = np.zeros(1 << capacity_pow, np.int64)  # 0 = never
        self.counters = {"added": 0, "evicted": 0}

    def _slots(self, keys: np.ndarray, p: int) -> np.ndarray:
        # probe p reads a different 16-bit window of the 64-bit key
        return (keys >> np.uint64(16 * p)).astype(np.int64) & self.mask

    def add_keys(self, keys: np.ndarray, now_s: int) -> None:
        """Mark pre-hashed hosts active at `now_s`."""
        if not len(keys):
            return
        self.counters["added"] += int(len(keys))
        live = self.stamp > now_s - self.lease_s
        for p in range(self.probes):
            slots = self._slots(keys, p)
            ours = self.keys[slots] == keys
            free = ~live[slots]
            take = ours | free
            w = slots[take]
            self.counters["evicted"] += int((free & ~ours & (self.stamp[slots] > 0))[take].sum())
            self.keys[w] = keys[take]
            self.stamp[w] = now_s
            # slots claimed THIS call are live for later probes, or a
            # probe-1 placement could overwrite a probe-0 write and
            # falsely deactivate a host added in the same batch
            live[w] = True
            keys = keys[~take]
            if not len(keys):
                break
        else:
            # all probes occupied by other live hosts: overwrite probe 0
            # (newest-wins, the LRU-evict analog)
            slots = self._slots(keys, 0)
            self.keys[slots] = keys
            self.stamp[slots] = now_s
            self.counters["evicted"] += len(keys)

    def check_keys(self, keys: np.ndarray, now_s: int) -> np.ndarray:
        hit = np.zeros(len(keys), bool)
        fresh = self.stamp > now_s - self.lease_s
        for p in range(self.probes):
            slots = self._slots(keys, p)
            hit |= (self.keys[slots] == keys) & fresh[slots]
        return hit

    def add(self, ip_words: np.ndarray, now_s: int, sel: np.ndarray | None = None) -> None:
        """Mark hosts as active at `now_s`. ip_words [N, 4] u32."""
        keys = _hash_ips(ip_words)
        self.add_keys(keys[sel] if sel is not None else keys, now_s)

    def check(self, ip_words: np.ndarray, now_s: int) -> np.ndarray:
        """[N, 4] ip words → [N] bool: seen originating traffic within
        the lease."""
        return self.check_keys(_hash_ips(ip_words), now_s)
