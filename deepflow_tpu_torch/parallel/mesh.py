"""Device mesh construction (port of deepflow_tpu/parallel/mesh.py).

Two logical axes mirror the reference's two scaling tiers:

  * `chip` — the devices of one host; the sketch merges of
    `ShardedPipeline.window_close` reduce over it first;
  * `host` — across hosts; the pod-wide 1-minute HLL view reduces over
    it after the chip axis.

The port's `Mesh` is the device grid and its axis names; nothing
compiles against it. Each grid cell is one logical shard. By default
every cell is its own CUDA device, and asking for more devices than
are visible raises. Several shards may share one device only when the
caller places them explicitly: `devices=[torch.device("cuda:0")] * 4`
runs four shards on one card, `devices=[torch.device("cpu")] * 2` two on
the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

MESH_AXES = ("host", "chip")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # [n_hosts, n_chips] object array of torch.device
    axis_names: tuple = MESH_AXES

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The shards' devices in (host, chip) row-major order — shard d
        of a `ShardedPipeline` lives on flat()[d]."""
        return list(self.devices.reshape(-1))


def make_mesh(n_devices: int | None = None, n_hosts: int = 1, devices=None) -> Mesh:
    """A (host, chip) mesh. Without `devices`, the first `n_devices`
    visible CUDA devices (all of them when None); raises when fewer are
    visible than asked for. With `devices`, exactly those (repeats
    allowed: shards sharing a device), `n_devices` ignored as in the
    reference."""
    if devices is None:
        resolve_device("cuda")  # raises without CUDA
        avail = torch.cuda.device_count()
        n = avail if n_devices is None else int(n_devices)
        if n > avail:
            raise ValueError(
                f"make_mesh asked for {n} devices but {avail} CUDA device(s) are "
                "visible; pass devices= to place several shards on one device"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if n == 0 or n % n_hosts:
        raise ValueError(f"{n} devices do not split over {n_hosts} hosts")
    arr = np.empty((n,), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_hosts, n // n_hosts))
