"""The device mesh, and the one module that moves data between shards.

The port's counterpart of jax.sharding.Mesh: an ordered grid of torch
devices with named axes. A device may repeat: a virtual mesh of four
shards on one card (or eight on the CPU, as the tests run it) partitions,
exchanges and runs the per-shard kernels as a mesh of distinct cards
would, and says nothing about speed across cards. The caller builds such
a mesh explicitly; `parallel/shard.make_mesh` takes distinct cards only.

Every byte that crosses between shards goes through this module: `place`
(a tensor onto a shard's device) and the three collectives below, written
as in-process copies:

- `concat`: per-shard outputs joined along one axis in shard order (the
  reference's `out_specs=P(axis)`);
- `all_to_all`: tile j of every source to destination j, in source
  order (`jax.lax.all_to_all(x, axis, 0, 0)`);
- `psum`: the exact host sum of per-shard scalar partials.

One process drives every shard. A mesh that would span processes (a
`torch.distributed` group of world size above 1) raises
NotImplementedError: a process-group transport belongs here, in one place
(ROADMAP.md item 11b).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "check_single_process", "place"]

_MULTI_PROCESS = ("a mesh across processes needs a process-group "
                  "transport in parallel/mesh.py (ROADMAP.md item 11b)")


def check_single_process() -> None:
    """Raise NotImplementedError where torch.distributed runs a group of
    more than one process: this module's copies reach only the devices of
    the calling process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(_MULTI_PROCESS)


def place(x: torch.Tensor, device) -> torch.Tensor:
    """x on `device`: an asynchronous copy where the target is a card (a
    copy to the host stays synchronous, so its result is complete when
    it returns); x itself where it is there already."""
    dev = torch.device(device)
    return x.to(dev, non_blocking=dev.type == "cuda")


class Mesh:
    """An ordered grid of torch devices with one name per axis.

    devices: a (nested) sequence or numpy array of devices or device
    strings; its shape is the mesh's. Exposes what the reference's callers
    read: `shape[axis]`, `axis_names`, `devices` (a numpy object array)."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self.devices = np.empty(arr.shape, object)
        for i, d in np.ndenumerate(arr):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> list[torch.device]:
        """The devices in row-major order (the shard order of a 1-d
        mesh)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"

    # ------------------------------------------------------ collectives --

    def concat(self, parts, device, dim: int = 0) -> torch.Tensor:
        """Per-shard tensors joined along `dim` in shard order, on
        `device`."""
        check_single_process()
        return torch.cat([place(p, device) for p in parts], dim=dim)

    def all_to_all(self, tiles) -> list[torch.Tensor]:
        """tiles[s]: [n, cap, ...] on shard s's device, n = number of
        shards. Destination j gets [n, cap, ...] on its own device: row s
        is tile j of source s."""
        check_single_process()
        devs = self.flat()
        n = len(tiles)
        if n != len(devs):
            raise ValueError(f"all_to_all: {n} sources on {len(devs)} shards")
        return [torch.stack([place(tiles[s][j], devs[j]) for s in range(n)])
                for j in range(n)]

    def psum(self, parts) -> int:
        """The exact sum of per-shard integer scalars, as a python int."""
        check_single_process()
        return sum(int(p) for p in parts)
