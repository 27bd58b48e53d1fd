"""A mesh of torch devices for multi-device rendering (the port of
`mathmap_tpu/parallel/mesh.py`).

The JAX package shards a render over a `jax.sharding.Mesh` inside one
program (`shard_map`). Here one process drives every tile: a mesh is an
ndarray of `torch.device`s, each tile's tensors live on its device, and a
device may appear more than once (a 4-tile mesh of one card runs the
multi-device path on one GPU; the CPU tests build the reference's (1,8,1)
and (1,2,4) meshes from "cpu" entries). Axis names:

    "f" — frame batch: a multi-frame render_sharded splits its frames
          over it in contiguous blocks; a one-frame render uses the
          first frame slice
    "y" — grid rows
    "x" — grid cols
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_AXIS = "f"
ROW_AXIS = "y"
COL_AXIS = "x"


class Mesh:
    """A (frames, rows, cols) ndarray of torch.device."""

    axis_names = (FRAME_AXIS, ROW_AXIS, COL_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is (frames, rows, cols), got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


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


def assemble(tiles: list, device: torch.device, out=None) -> torch.Tensor:
    """(rows, cols) nested lists of (tile_h, tile_w, C) tiles -> the whole
    (H, W, C) frame on `device`, written into `out` when given."""
    return torch.cat([torch.cat([t.to(device, non_blocking=True) for t in row], dim=1)
                      for row in tiles], dim=0, out=out)
