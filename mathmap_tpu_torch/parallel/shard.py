"""Sharded rendering over a mesh with replicated inputs (the port of
`mathmap_tpu/parallel/shard.py`).

Each tile builds its OWN coordinate grids from its offsets and evaluates
the filter over them, so pointwise and generative filters need no
communication at all; sampling filters get a copy of every input image on
the tile's device, so any displacement stays local (the input-sharded path
for inputs too large to replicate is parallel/halo.py). A tile samples
through kernel B1, and its loops and LUTs go through kernels B3 and B2, as
the unsharded render's do. One process drives every tile. A sweep of
frames splits over the mesh's frame axis in contiguous blocks: frame slice
k renders its block of frames over its own (rows, cols) tiles.
"""

from __future__ import annotations

import torch

from ..runtime.render import render_frame, user_values, validate_params
from ..runtime.tracer import RenderContext
from ..runtime.value import InputImage
from ..utils.errors import MMRuntimeError
from .mesh import COL_AXIS, FRAME_AXIS, ROW_AXIS, assemble, axis_size


def _check_divisible(total: int, parts: int, what: str):
    if total % parts:
        raise MMRuntimeError(f"{what} ({total}) must be divisible by its mesh axis ({parts})")


def _render_tiles(devices, replicas: dict, program_filters, fdef, width: int, height: int,
                  opts, inputs: list, params: dict, t: float, frame: float, out=None):
    """One frame over the (rows, cols) tile `devices` -> (H, W, 4) on
    devices[0, 0], or written into `out` on its device. `replicas` maps a device
    to its copies of `inputs`, made on first use and reused by later
    frames."""
    ny, nx = devices.shape
    tile_h, tile_w = height // ny, width // nx
    tiles = []
    for r in range(ny):
        row = []
        for c in range(nx):
            dev = devices[r, c]
            if dev not in replicas:
                replicas[dev] = [a.to(dev, non_blocking=True) for a in inputs]
            ctx = RenderContext(
                device=dev, width=width, height=height, opts=opts,
                filters=program_filters, t=float(t), frame=float(frame),
                inputs=[InputImage(pixels=a, name=f"in{i}")
                        for i, a in enumerate(replicas[dev])],
                grid_shape=(tile_h, tile_w),
                row_offset=r * tile_h, col_offset=c * tile_w)
            row.append(render_frame(ctx, fdef, user_values(ctx, fdef, params)))
        tiles.append(row)
    return assemble(tiles, devices[0, 0] if out is None else out.device, out=out)


def _check_grid(mesh, width: int, height: int):
    _check_divisible(height, axis_size(mesh, ROW_AXIS), "height")
    _check_divisible(width, axis_size(mesh, COL_AXIS), "width")


def render_frame_sharded(mesh, program_filters, fdef, width: int, height: int,
                         opts, inputs: list, params: dict, t: float = 0.0,
                         frame: float = 0.0) -> torch.Tensor:
    """One frame, the grid split over the (y, x) axes of the mesh's first
    frame slice -> (H, W, 4) on the mesh's first device. `inputs`: (H, W,
    4) or animated (T, H, W, 4) float32 or uint8 tensors, copied whole to
    every tile's device (once per distinct device); `params`: the caller's
    param values."""
    validate_params(fdef, params, opts.static_params)
    _check_grid(mesh, width, height)
    return _render_tiles(mesh.devices[0], {}, program_filters, fdef, width, height,
                         opts, inputs, params, t, frame)


def render_frames_sharded(mesh, program_filters, fdef, width: int, height: int,
                          opts, inputs: list, params: dict, ts) -> torch.Tensor:
    """A sweep of len(ts) frames: frame i at t = ts[i] with its `frame`
    internal i, the frames split over the mesh's frame axis in contiguous
    blocks and each frame's grid over its slice's (y, x) tiles -> (F, H, W,
    4) on the mesh's first device. The frame count must divide by the
    frame axis."""
    validate_params(fdef, params, opts.static_params)
    _check_grid(mesh, width, height)
    n = len(ts)
    nf = axis_size(mesh, FRAME_AXIS)
    _check_divisible(n, nf, "num_frames")
    per_slice = n // nf
    devices = mesh.devices
    first = devices[0, 0, 0]
    dtype = torch.uint8 if opts.output_dtype == "uint8" else torch.float32
    out = torch.empty((n, height, width, 4), dtype=dtype, device=first)
    replicas = {}
    for i in range(n):
        _render_tiles(devices[i // per_slice], replicas, program_filters, fdef, width,
                      height, opts, inputs, params, float(ts[i]), float(i), out=out[i])
    return out
