"""A mesh of torch devices for multi-device rendering (the port of
`mathmap_tpu/parallel/mesh.py`).

The JAX package shards a render over a `jax.sharding.Mesh` inside one
program (`shard_map`). Here one process drives every tile it owns: a mesh
is an ndarray of `torch.device`s, each tile's tensors live on its device,
and a device may appear more than once (a 4-tile mesh of one card runs the
multi-device path on one GPU; the CPU tests build the reference's (1,8,1)
and (1,2,4) meshes from "cpu" entries). A mesh that spans processes
(parallel/distributed.global_mesh) also names each entry's owning rank;
a process owns every entry of a mesh made by `make_mesh`. Axis names:

    "f" — frame batch: a multi-frame render_sharded splits its frames
          over it in contiguous blocks; a one-frame render uses the
          first frame slice
    "y" — grid rows
    "x" — grid cols
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import count, span

FRAME_AXIS = "f"
ROW_AXIS = "y"
COL_AXIS = "x"


class Mesh:
    """A (frames, rows, cols) ndarray of torch.device. A mesh that spans
    processes (parallel/distributed.global_mesh) also holds the rank that
    owns each entry and this process's rank: a render over it evaluates
    only this rank's tiles."""

    axis_names = (FRAME_AXIS, ROW_AXIS, COL_AXIS)

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None, rank: int = 0):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is (frames, rows, cols), got {devices.shape}")
        if ranks is not None and ranks.shape != devices.shape:
            raise ValueError(f"ranks {ranks.shape} must match the devices {devices.shape}")
        self.devices = devices
        self.ranks = ranks
        self.rank = rank

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    def owner(self, index) -> int:
        """The rank that owns the entry at `index` (f, y, x)."""
        return self.rank if self.ranks is None else int(self.ranks[index])

    def is_local(self, index) -> bool:
        """Whether this process owns the entry at `index` (f, y, x)."""
        return self.owner(index) == self.rank

    def local_entries(self, f: int | None = None) -> list:
        """This rank's entry indices (f, y, x) in mesh order; with `f`,
        those of frame slice f only."""
        return [i for i in np.ndindex(self.devices.shape)
                if self.is_local(i) and (f is None or i[0] == f)]

    @property
    def first_local(self) -> torch.device:
        """The first device, in mesh order, that this process owns."""
        local = self.local_entries()
        if not local:
            raise ValueError(f"rank {self.rank} owns no device of this mesh")
        return self.devices[local[0]]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {str(d)!r} requested but no CUDA GPU is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(frames: int = 1, rows: int | None = None, cols: int = 1,
              devices=None) -> Mesh:
    """Build a (frames, rows, cols) mesh. `devices` defaults to every
    visible CUDA device and raises without one (there is no CPU default:
    pass devices=["cpu"] * n); an entry may repeat. `rows=None` puts the
    remaining devices on the row axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA GPU is available (pass devices=['cpu'] * n "
                "for a CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if rows is None:
        if n % (frames * cols):
            raise ValueError(f"{n} devices not divisible by frames*cols={frames * cols}")
        rows = n // (frames * cols)
    if frames * rows * cols != n:
        raise ValueError(f"mesh {frames}x{rows}x{cols} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(frames, rows, cols))


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


_ASSEMBLE = span("mm.shard.assemble")


def peer_copy(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`a` on `device`, a copy that does not wait for the host where it
    crosses devices; the bytes of a copy to a device other than its own
    add to the counter `shard.peer_bytes`."""
    if a.device != device:
        count("shard.peer_bytes", a.numel() * a.element_size())
    return a.to(device, non_blocking=True)


def assemble(tiles: list, device: torch.device, out=None) -> torch.Tensor:
    """(rows, cols) nested lists of (tile_h, tile_w, C) tiles -> the whole
    (H, W, C) frame on `device`, written into `out` when given: one
    `mm.shard.assemble` span, the tiles moved and joined."""
    with _ASSEMBLE:
        return torch.cat([torch.cat([peer_copy(t, device) for t in row], dim=1)
                          for row in tiles], dim=0, out=out)
