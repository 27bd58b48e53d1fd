"""Multi-process renders on `torch.distributed` (the port of
`mathmap_tpu/parallel/distributed.py`).

The reference wires `jax.distributed` so that one `shard_map` program
spans the devices of several hosts. Here each process is one rank of a
`torch.distributed` process group: `initialize` joins it, `global_mesh`
builds a mesh of every rank's devices in rank order, and
`Filter.render_sharded` over that mesh has each rank evaluate only the
tiles of its own devices (parallel/shard.py), the single-controller design
applied per rank. `local_slice_of` gives those tiles. The collectives a
fleet needs beyond that (a sum over ranks, a ring exchange) are
`torch.distributed`'s own, on the backend the group was made with: NCCL
for CUDA ranks, gloo for CPU ranks. Nothing here reads a cluster's
environment: the caller names the coordinator, the world size and its
rank.

    from mathmap_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    mesh = distributed.global_mesh()          # every rank's GPUs on the rows
    frame = f.render_sharded(img, mesh=mesh)  # this rank's tiles
    tiles = distributed.local_slice_of(frame)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, make_mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join the render fleet's process group: `coordinator_address` is
    "host:port" (or a tcp:// URL) of rank 0, `num_processes` the world
    size, `process_id` this rank. `backend` defaults to NCCL when this
    process renders on a GPU and gloo otherwise (MMTPU_PLATFORM=cpu or no
    GPU). Idempotent: a process already in a group returns at once."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator's address, the number of "
                         "processes and this process's id (nothing here reads a "
                         "cluster's environment)")
    if backend is None:
        gpu = torch.cuda.is_available() and os.environ.get("MMTPU_PLATFORM") != "cpu"
        backend = "nccl" if gpu else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


def is_multihost() -> bool:
    """Whether this process is one of several ranks."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(frames: int = 1, rows: int | None = None, cols: int = 1,
                devices=None) -> Mesh:
    """A (frames, rows, cols) mesh of every rank's devices in rank order,
    each entry owned by the rank that contributed it. `devices` is this
    rank's list (default every visible GPU; ["cpu"] * n on CPU ranks;
    entries may repeat, as in make_mesh); every rank calls this
    collectively."""
    import torch.distributed as dist

    local = make_mesh(devices=devices).devices.reshape(-1)
    world, rank = dist.get_world_size(), dist.get_rank()
    gathered: list = [None] * world
    dist.all_gather_object(gathered, [str(d) for d in local])
    flat = [(r, torch.device(d)) for r in range(world) for d in gathered[r]]
    mesh = make_mesh(frames, rows, cols, devices=["cpu"] * len(flat))
    owners = np.array([r for r, _ in flat]).reshape(mesh.devices.shape)
    arr = np.empty(len(flat), dtype=object)
    # this rank's entries are its own devices; another rank's entry names
    # its device there and is never touched here
    arr[:] = [d for _, d in flat]
    return Mesh(arr.reshape(mesh.devices.shape), ranks=owners, rank=rank)


def local_slice_of(frame) -> list:
    """The tiles of a frame rendered over a mesh that spans processes
    (shard.LocalFrame) that this rank owns, in mesh order: what this rank
    writes out. `frame.tiles` maps each to its global (row, col) origin."""
    return list(frame.tiles.values())
