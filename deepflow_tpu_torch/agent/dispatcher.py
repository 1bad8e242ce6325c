"""Dispatcher modes — vectorized local / mirror / analyzer orientation.

Port copy of deepflow_tpu/agent/dispatcher.py.

The reference runs one dispatcher flavor per deployment shape
(dispatcher/mod.rs DispatcherFlavor): *local* captures a host's own
interfaces (a side is "ours" when its MAC is a local interface MAC),
*mirror* receives bridge-mirrored VM traffic (side identity = the
controller-pushed VM MAC set, keyed on the MAC's low 32 bits,
mirror_mode_dispatcher.rs:103), and *analyzer* terminates span/ERSPAN
feeds where no endpoint is local and the outer VLAN id maps to a
tap_type (the trisolaris tap-type table). Flavors there are separate
recv pipelines; here orientation is one vectorized pass over the
parsed batch — the capture engine is shared, the MODE is data.

`orient()` returns per-packet (tap_type, l2_end_src, l2_end_dst):
which sides of each packet terminate on this agent's domain, and the
tap the packet was seen on. FlowMap folds these into per-flow lanes
(OR for ends, FIRST for tap_type) and emission derives tap_side the
way document.rs TapSide::from does."""

from __future__ import annotations

import dataclasses

import numpy as np

# TapType constants (the reference reserves 3 for "cloud"/local
# traffic; ISP span positions are 1/2/4..7, trident.proto TapType)
TAP_CLOUD = 3


@dataclasses.dataclass
class DispatcherConfig:
    mode: str = "local"  # local | mirror | analyzer
    # mirror mode: VM/bridge MAC set (low 32 bits, like the reference's
    # to_lower_32b keys); local mode: this host's interface MACs —
    # empty means "every packet is ours" (single-host default)
    macs: tuple[int, ...] = ()
    # analyzer mode: outer VLAN id → tap_type; unmapped VLANs fall to
    # default_tap_type
    vlan_tap_map: dict | None = None
    default_tap_type: int = TAP_CLOUD


class Dispatcher:
    def __init__(self, config: DispatcherConfig = DispatcherConfig()):
        if config.mode not in ("local", "mirror", "analyzer"):
            raise ValueError(f"unknown dispatcher mode {config.mode!r}")
        self.config = config
        # full 48-bit MACs are accepted and keyed on their low 32 bits
        # (the same to_lower_32b reduction the reference applies)
        self._mac_set = np.asarray(
            sorted({int(m) & 0xFFFFFFFF for m in config.macs}), np.uint32
        )
        vt = config.vlan_tap_map or {}
        self._vlan_ids = np.asarray(sorted(vt), np.uint32)
        self._vlan_taps = np.asarray(
            [vt[int(v)] for v in self._vlan_ids], np.uint32
        )
        self.counters = {"packets": 0, "oriented": 0}

    def _in_macs(self, macs: np.ndarray) -> np.ndarray:
        if self._mac_set.size == 0:
            return np.zeros(macs.shape[0], bool)
        idx = np.searchsorted(self._mac_set, macs)
        idx = np.clip(idx, 0, self._mac_set.size - 1)
        return self._mac_set[idx] == macs

    def orient(self, p) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """PacketBatch → (tap_type [N] u32, l2_end_src [N] bool,
        l2_end_dst [N] bool)."""
        n = p.size
        mode = self.config.mode
        self.counters["packets"] += int(n)
        tap = np.full(n, self.config.default_tap_type, np.uint32)
        if mode == "analyzer":
            # span feed: no side is local; tap from the VLAN table
            if self._vlan_ids.size:
                idx = np.clip(
                    np.searchsorted(self._vlan_ids, p.vlan_id),
                    0, self._vlan_ids.size - 1,
                )
                hit = self._vlan_ids[idx] == p.vlan_id
                tap = np.where(hit, self._vlan_taps[idx], tap).astype(np.uint32)
            return tap, np.zeros(n, bool), np.zeros(n, bool)
        if mode == "mirror":
            src = self._in_macs(p.mac_src_lo)
            dst = self._in_macs(p.mac_dst_lo)
        else:  # local
            if self._mac_set.size == 0:
                # single-host default: we captured it, so one side is
                # ours — the sender for egress frames; without MACs the
                # best static claim is both-ends-local loopback stance
                src = np.ones(n, bool)
                dst = np.ones(n, bool)
            else:
                src = self._in_macs(p.mac_src_lo)
                dst = self._in_macs(p.mac_dst_lo)
        self.counters["oriented"] += int((src | dst).sum())
        return tap, src, dst
