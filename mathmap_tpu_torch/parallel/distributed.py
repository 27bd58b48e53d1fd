"""Multi-process renders on `torch.distributed` (the port of
`mathmap_tpu/parallel/distributed.py`).

The reference wires `jax.distributed` so that one `shard_map` program
spans the devices of several hosts. Here each process is one rank of a
`torch.distributed` process group: `initialize` joins it, `global_mesh`
builds a mesh of every rank's devices in rank order, and a render over
that mesh has each rank evaluate only the tiles of its own devices, the
single-controller design applied per rank:

- `Filter.render_sharded` (parallel/shard.py) needs no message: every
  rank has the inputs whole; a sweep of frames gives each rank the frame
  shards of its entries;
- `Filter.render_tiled` (parallel/halo.py) splits the inputs, so halo
  rows and columns cross ranks through `exchange` (the reference's
  `ppermute`) and the halo check's excess through `all_reduce_max` (its
  `pmax`).

`local_slice_of` gives a rank's tiles or frame shards. Messages go over
the backend the group was made with: NCCL for CUDA ranks (device tensors,
unverified between two cards), gloo for CPU ranks and for several ranks on
one card (blocks staged through the host). Nothing here reads a cluster's
environment: the caller names the coordinator, the world size and its
rank.

    from mathmap_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    mesh = distributed.global_mesh()          # every rank's GPUs on the rows
    frame = f.render_tiled(img, mesh=mesh)    # this rank's tiles
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
    """What this rank owns of a render over a mesh that spans processes
    (shard.LocalFrame), in mesh order: a frame's (tile_h, tile_w, 4) tiles,
    or a sweep's (F / nf, tile_h, tile_w, 4) frame shards, the shard shape
    of the reference's (F, H, W, 4) array over (f, y, x). `frame.tiles`
    maps each to its global (row, col) or (frame, row, col) origin."""
    return list(frame.tiles.values())


def _wire(device: torch.device) -> torch.device:
    """Where a message's tensor lives: the host under gloo, which sends
    and receives CPU tensors only, the block's device otherwise (NCCL)."""
    import torch.distributed as dist

    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def exchange(sends: list, recvs: list) -> list:
    """One phase of point-to-point messages, every send and receive posted
    at once (`batch_isend_irecv`), then waited on. `sends`: (peer rank,
    tensor) pairs; `recvs`: (peer rank, shape, dtype, device) -> the
    received tensors, in order, each on its device. Both lists follow the
    phase's global order, which every rank enumerates alike: the k-th
    message from rank a to rank b is a's k-th send to b and b's k-th
    receive from a (its tag under gloo; NCCL matches by order)."""
    import torch.distributed as dist

    ops, bufs = [], []
    seq_out: dict = {}
    for peer, tensor in sends:
        # gloo: a blocking copy to the host, so the piece has landed before
        # the send is posted; NCCL orders its send after the queued work
        msg = tensor.to(_wire(tensor.device)).contiguous()
        tag = seq_out[peer] = seq_out.get(peer, -1) + 1
        ops.append(dist.P2POp(dist.isend, msg, peer, tag=tag))
    seq_in: dict = {}
    for peer, shape, dtype, device in recvs:
        buf = torch.empty(shape, dtype=dtype, device=_wire(device))
        bufs.append((buf, device))
        tag = seq_in[peer] = seq_in.get(peer, -1) + 1
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [buf.to(device) for buf, device in bufs]


def all_reduce_max(value: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's `value` (a 0-d tensor), on the wire's
    device (the host under gloo): the reference's `pmax`. Every rank must
    call it."""
    import torch.distributed as dist

    buf = value.to(_wire(value.device)).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return buf
