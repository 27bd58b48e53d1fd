"""Sharded rendering over a mesh with replicated inputs (the port of
`mathmap_tpu/parallel/shard.py`, one frame).

Each tile builds its OWN coordinate grids from its offsets and evaluates
the filter over them, so pointwise and generative filters need no
communication at all; sampling filters get a copy of every input image on
the tile's device, so any displacement stays local (the input-sharded path
for inputs too large to replicate is parallel/halo.py). A tile samples
through kernel B1, and its loops and LUTs go through kernels B3 and B2, as
the unsharded render's do. One process drives every tile; the frame axis
and frame batches are not ported (ROADMAP A4).
"""

from __future__ import annotations

import torch

from ..runtime.render import render_frame, user_values, validate_params
from ..runtime.tracer import RenderContext
from ..runtime.value import InputImage
from ..utils.errors import MMRuntimeError
from .mesh import COL_AXIS, ROW_AXIS, assemble, axis_size, tile_devices


def _check_divisible(total: int, parts: int, what: str):
    if total % parts:
        raise MMRuntimeError(f"{what} ({total}) must be divisible by its mesh axis ({parts})")


def render_frame_sharded(mesh, program_filters, fdef, width: int, height: int,
                         opts, inputs: list, params: dict, t: float = 0.0,
                         frame: float = 0.0) -> torch.Tensor:
    """One frame, the grid split over the mesh's (y, x) axes -> (H, W, 4)
    on the mesh's first device. `inputs`: (H, W, 4) float32 or uint8
    tensors, copied whole to every tile's device (once per distinct
    device); `params`: the caller's param values."""
    validate_params(fdef, params, opts.static_params)
    devices = tile_devices(mesh)
    ny, nx = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    _check_divisible(height, ny, "height")
    _check_divisible(width, nx, "width")
    tile_h, tile_w = height // ny, width // nx
    replicas = {}
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
    return assemble(tiles, devices[0, 0])

