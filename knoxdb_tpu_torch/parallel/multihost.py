"""Multi-process start-up and the hybrid (hosts, packs) mesh (the port of
knoxdb_tpu/parallel/multihost.py).

The reference's shape, kept: one process per host joined through the
coordinator variables (`initialize_from_env`), a HYBRID mesh whose outer
axis enumerates hosts and whose inner axis enumerates each host's cards
(`hybrid_mesh`), and `attach`, which flattens it host-major into the one
pack axis the engine's scan partitions, so every host owns a contiguous
pack (= pk) range and only the per-pack partials cross between hosts.

Every data movement between shards goes through parallel/mesh.py, which
reaches only the devices of the calling process: a mesh whose outer axis
spans processes raises NotImplementedError until a process-group
transport lands there (ROADMAP.md item 11b). A single process, and the
CPU test mesh, run unchanged: `initialize_from_env` is a no-op without
the coordinator variables, and `hybrid_mesh` has one host row unless
KNOX_VIRTUAL_HOSTS asks for a virtual factorization (tests).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import _MULTI_PROCESS, Mesh

__all__ = ["initialize_from_env", "hybrid_mesh", "attach"]


def initialize_from_env() -> bool:
    """Join the process group when the coordinator variables are set
    (KNOX_COORDINATOR or JAX_COORDINATOR_ADDRESS as host:port, with
    KNOX_NUM_PROCESSES and KNOX_PROCESS_ID), through
    torch.distributed.init_process_group: nccl where the process has a
    card, gloo otherwise. Returns True when the group is up, False when
    the variables are absent. Safe to call more than once."""
    coord = os.environ.get("KNOX_COORDINATOR") \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("KNOX_NUM_PROCESSES")
    pid = os.environ.get("KNOX_PROCESS_ID")
    if coord is None and nproc is None:
        return False
    dist = torch.distributed
    if dist.is_initialized():
        return True                       # already initialized
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coord or 'localhost:29500'}",
        world_size=int(nproc or 1), rank=int(pid or 0))
    return True


def _process_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("hybrid_mesh: this process has no CUDA device; "
                           "pass devices= for a mesh of other devices")
    return [torch.device("cuda", i) for i in range(n)]


def hybrid_mesh(hosts_axis: str = "hosts", chips_axis: str = "packs",
                devices=None) -> Mesh:
    """(n_hosts, cards_per_host) mesh: the outer axis spans processes, the
    inner each process's cards. With one process it has one host row,
    unless KNOX_VIRTUAL_HOSTS forces a row-major factorization (tests)."""
    devs = list(devices) if devices is not None else _process_devices()
    vh = int(os.environ.get("KNOX_VIRTUAL_HOSTS", "0"))
    dist = torch.distributed
    nproc = dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1
    if nproc > 1 and vh <= 1:
        # each process sees only its own cards: a grid over every host's
        # cards needs the transport this package does not have yet
        raise NotImplementedError(_MULTI_PROCESS)
    if vh > 1 and len(devs) % vh == 0:
        grid = np.empty((vh, len(devs) // vh), object)
        for i, d in enumerate(devs):
            grid[i // grid.shape[1], i % grid.shape[1]] = torch.device(d)
        return Mesh(grid, (hosts_axis, chips_axis))
    grid = np.empty((1, len(devs)), object)
    for i, d in enumerate(devs):
        grid[0, i] = torch.device(d)
    return Mesh(grid, (hosts_axis, chips_axis))


def attach(engine, mesh: Mesh | None = None) -> Mesh:
    """Wire a (hybrid) mesh into an engine: flattened HOST-MAJOR into one
    ("packs",) axis, so every host owns a contiguous pack range. Returns
    the flat mesh that was attached."""
    if mesh is None:
        mesh = hybrid_mesh()
    flat = Mesh(mesh.devices.reshape(-1), ("packs",))
    engine.mesh = flat
    return flat
