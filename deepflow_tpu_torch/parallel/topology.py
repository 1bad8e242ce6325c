"""Mesh topology and key-hash shard-group placement — the single-process
part (port of deepflow_tpu/parallel/topology.py).

The pod's devices form ONE logical mesh, split into shard groups; each
group belongs to exactly one process (host). Agents route to groups by
hashing their packed identity words, so the data path never crosses
hosts: every `ShardedPipeline` runs on its group's own devices
(`group_mesh`), and each host owns its feeder, journal and checkpoint,
whose filenames carry the process index (`host_path`). A restoring host
rebuilds its groups from its own files alone (`standalone`).

`agent_key_words` / `key_shard_group` are bit-equal to the reference's
(the same packing and the same murmur fold, ops/hashing.py). Not ported
yet: `MeshTopology.distributed` and `global_mesh`, which need a process
group (`torch.distributed`), and the rebalance and host-process
harness around them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..ops.hashing import fingerprint64_words
from .mesh import MESH_AXES, Mesh, make_mesh

AXIS_HOST, AXIS_CHIP = MESH_AXES


# ---------------------------------------------------------------------------
# key-hash fan-in (the receiver's routing function)


def agent_key_words(org_id, agent_id) -> list:
    """The packed identity words the fan-in hash folds: org and agent ids
    bin-packed into u32 words (u16 fields share a word). Scalars or
    equal-length arrays; returns [N] uint32 numpy words."""
    org = np.atleast_1d(np.asarray(org_id, dtype=np.uint32))
    agent = np.atleast_1d(np.asarray(agent_id, dtype=np.uint32))
    return [(org << np.uint32(16)) | (agent & np.uint32(0xFFFF)),
            agent >> np.uint32(16)]


def key_shard_group(org_id, agent_id, n_groups: int):
    """Key-hash fan-in: (org, agent) → shard group through the packed doc
    keys' fingerprint fold, a pure function every host computes the same
    way. Scalars in → int out; arrays in → int64 array out."""
    if n_groups <= 0:
        raise ValueError(f"n_groups must be positive, got {n_groups}")
    words = [torch.from_numpy(w.astype(np.int64)) for w in agent_key_words(org_id, agent_id)]
    hi, lo = (x.numpy().astype(np.uint64) for x in fingerprint64_words(words))
    group = (hi ^ lo) % np.uint64(n_groups)
    if np.ndim(org_id) == 0 and np.ndim(agent_id) == 0:
        return int(group[0])
    return group.astype(np.int64)


# ---------------------------------------------------------------------------
# the topology


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Placement of shard groups onto processes over one logical mesh:
    `n_groups` groups of `devices_per_group` devices, block-assigned to
    `process_count` processes in order (n_groups must divide evenly),
    with rebalance overrides ((group, process) pairs in adoption order)
    stamped by `topology_epoch`."""

    process_index: int
    process_count: int
    n_groups: int
    devices_per_group: int
    local_devices: tuple = dataclasses.field(repr=False)
    group_overrides: tuple = ()
    topology_epoch: int = 0

    def __post_init__(self):
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(
                f"process_index {self.process_index} outside [0, {self.process_count})"
            )
        if self.n_groups % self.process_count:
            raise ValueError(
                f"{self.n_groups} shard groups cannot block-assign onto "
                f"{self.process_count} processes (must divide evenly)"
            )
        for g, p in self.group_overrides:
            self._check_group(g)
            if not (0 <= p < self.process_count):
                raise ValueError(
                    f"override sends group {g} to process {p}, outside "
                    f"[0, {self.process_count})"
                )
        need = (self.groups_per_process + len(self._adopted_groups())) * self.devices_per_group
        if len(self.local_devices) < need:
            raise ValueError(
                f"process {self.process_index} owns {self.groups_per_process} block "
                f"groups + {len(self._adopted_groups())} adopted groups × "
                f"{self.devices_per_group} devices = {need} devices but only "
                f"{len(self.local_devices)} are local"
            )

    # -- construction ----------------------------------------------------
    @classmethod
    def single(cls, n_groups: int = 1, *, devices_per_group: int = 1,
               devices=None) -> "MeshTopology":
        """One process owning every shard group. `devices` defaults to the
        visible CUDA devices."""
        devs = tuple(make_mesh(devices=devices).flat())
        return cls(process_index=0, process_count=1, n_groups=n_groups,
                   devices_per_group=devices_per_group, local_devices=devs)

    @classmethod
    def standalone(cls, process_index: int, process_count: int, *,
                   n_groups: int | None = None, devices_per_group: int = 1,
                   devices=None) -> "MeshTopology":
        """One host's view of a multi-host topology without any
        coordination: the data path never crosses hosts, so a restoring
        host rebuilds its groups, replays its journal and drains alone."""
        devs = tuple(make_mesh(devices=devices).flat())
        return cls(process_index=process_index, process_count=process_count,
                   n_groups=process_count if n_groups is None else n_groups,
                   devices_per_group=devices_per_group, local_devices=devs)

    # -- placement -------------------------------------------------------
    @property
    def groups_per_process(self) -> int:
        return self.n_groups // self.process_count

    def group_process(self, group: int) -> int:
        """The process that owns `group` (block assignment unless an
        override moved it)."""
        self._check_group(group)
        for g, p in self.group_overrides:
            if g == group:
                return p
        return group // self.groups_per_process

    def _adopted_groups(self) -> tuple[int, ...]:
        """Groups this process owns through an override, in adoption
        order: they sit on the local device slices after the block ones."""
        gpp = self.groups_per_process
        return tuple(g for g, p in self.group_overrides
                     if p == self.process_index and g // gpp != self.process_index)

    def owned_groups(self) -> tuple[int, ...]:
        g0 = self.process_index * self.groups_per_process
        block = tuple(g for g in range(g0, g0 + self.groups_per_process)
                      if self.group_process(g) == self.process_index)
        return block + self._adopted_groups()

    def rebalanced(self, group: int, to_process: int) -> "MeshTopology":
        """A new topology epoch that moves `group` to `to_process` — pure,
        so every host applying the same move derives the same topology."""
        self._check_group(group)
        if not (0 <= to_process < self.process_count):
            raise ValueError(
                f"cannot move group {group} to process {to_process}: outside "
                f"[0, {self.process_count})"
            )
        overrides = dict(self.group_overrides)  # keeps adoption order
        # a re-adoption appends as the newest adoption
        overrides.pop(group, None)
        if group // self.groups_per_process != to_process:
            overrides[group] = to_process
        return dataclasses.replace(self, group_overrides=tuple(overrides.items()),
                                   topology_epoch=self.topology_epoch + 1)

    def owns_group(self, group: int) -> bool:
        self._check_group(group)
        return self.group_process(group) == self.process_index

    def group_for_agent(self, org_id: int, agent_id: int) -> int:
        """Key-hash fan-in routing (the receiver's function)."""
        return key_shard_group(org_id, agent_id, self.n_groups)

    def _check_group(self, group: int) -> None:
        if not (0 <= group < self.n_groups):
            raise ValueError(f"shard group {group} outside [0, {self.n_groups})")

    # -- meshes ----------------------------------------------------------
    def group_mesh(self, group: int) -> Mesh:
        """The (1, devices_per_group) mesh of one local group. Raises for
        a group another process owns: the data path never crosses hosts."""
        self._check_group(group)
        if not self.owns_group(group):
            raise ValueError(
                f"shard group {group} is owned by process {self.group_process(group)}, "
                f"not this process ({self.process_index}) — the data path never "
                "crosses hosts; route the frames there instead (key-hash fan-in)"
            )
        adopted = self._adopted_groups()
        if group in adopted:
            k = self.groups_per_process + adopted.index(group)
        else:
            k = group - self.process_index * self.groups_per_process
        dpg = self.devices_per_group
        return make_mesh(devices=self.local_devices[k * dpg:(k + 1) * dpg])

    # -- per-host ownership ----------------------------------------------
    def host_path(self, base, group: int | None = None) -> Path:
        """`base` with the process index (and the shard group) in its
        name: recovery replays only this host's frames."""
        base = Path(base)
        tag = f"p{self.process_index}of{self.process_count}"
        if group is not None:
            tag = f"g{group}.{tag}"
        return base.with_name(f"{base.name}.{tag}")

    # -- checkpoint topology contract ------------------------------------
    def describe(self) -> dict:
        """The meta a sharded checkpoint embeds (validated at restore)."""
        return {
            "process_index": self.process_index,
            "process_count": self.process_count,
            "n_groups": self.n_groups,
            "devices_per_group": self.devices_per_group,
            "topology_epoch": self.topology_epoch,
        }

    def validate_restore(self, meta: dict, path) -> None:
        """Loud topology check of a checkpoint's meta: process count,
        group count and devices per group must match exactly — per-device
        stashes cannot be re-split."""
        saved_pc = meta.get("process_count")
        if saved_pc is None:
            return  # pre-topology file: the n_devices check is the contract
        mismatches = []
        for key, have in (("process_count", self.process_count),
                          ("n_groups", self.n_groups),
                          ("devices_per_group", self.devices_per_group)):
            want = meta.get(key)
            if want is not None and int(want) != int(have):
                mismatches.append(f"{key}: checkpoint={want} restore={have}")
        if mismatches:
            saved_shape = (f"{meta.get('devices_per_group')}d×{saved_pc}p"
                           f"/{meta.get('n_groups')}g")
            here_shape = (f"{self.devices_per_group}d×{self.process_count}p"
                          f"/{self.n_groups}g")
            raise ValueError(
                f"checkpoint {path} was saved on mesh topology {saved_shape} but this "
                f"process restores into {here_shape} ({'; '.join(mismatches)}) — "
                "per-device stashes cannot be re-split across a different topology"
            )
