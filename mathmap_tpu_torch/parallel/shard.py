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

Spans and counters (utils/trace.py): each frame of a sweep is a
`mm.frame`, each tile's render on its device (context, params,
`render_frame`) a `mm.shard.tile`, each input copied to a tile's device a
`mm.shard.replicate`, and a frame's tiles moved to the first device and
joined a `mm.shard.assemble` (parallel/mesh.py::assemble). The counter
`shard.tiles` counts the tiles rendered, `shard.peer_bytes` the bytes of
the input replicas and the tiles copied to a device other than their own
(0 on a mesh of one device).

Over a mesh that spans processes (parallel/distributed.global_mesh) each
rank evaluates only the tiles of its own devices, and a frame is a
`LocalFrame` of those tiles (distributed.local_slice_of): the
single-controller design, applied per rank. A sweep gives each rank the
frame shards of its entries, as a `LocalFrame` too. No pixel crosses
processes here, since every rank has the inputs whole (the input-sharded
render, parallel/halo.py, is the one that exchanges blocks between
ranks).
"""

from __future__ import annotations

import torch

from ..runtime.render import render_frame, user_values, validate_params
from ..runtime.tracer import RenderContext
from ..runtime.value import InputImage
from ..utils.errors import MMRuntimeError
from ..utils.trace import count, span
from .mesh import COL_AXIS, FRAME_AXIS, ROW_AXIS, assemble, axis_size, peer_copy

_FRAME = span("mm.frame")
_TILE = span("mm.shard.tile")
_REPLICATE = span("mm.shard.replicate")


def _check_divisible(total: int, parts: int, what: str):
    if total % parts:
        raise MMRuntimeError(f"{what} ({total}) must be divisible by its mesh axis ({parts})")


class LocalFrame:
    """This process's part of a render over a mesh that spans processes:
    for one frame, `tiles` maps each tile's global (row, col) origin to its
    (tile_h, tile_w, 4) tensor; for a sweep of F frames over nf frame
    slices, each shard's (frame, row, col) origin to its (F / nf, tile_h,
    tile_w, 4) tensor. In mesh order; `shape` is the whole result's, (H, W,
    4) or (F, H, W, 4)."""

    def __init__(self, tiles: dict, shape: tuple):
        self.tiles = tiles
        self.shape = shape


def _replicate(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One input copied to a tile's device: a `mm.shard.replicate` span."""
    with _REPLICATE:
        return peer_copy(a, device)


def _render_tiles(mesh, f: int, replicas: dict, program_filters, fdef, width: int,
                  height: int, opts, inputs: list, params: dict, t: float, frame: float,
                  out=None):
    """One frame over the (rows, cols) tiles of the mesh's frame slice `f`
    -> (H, W, 4) on its first device, or written into `out` on its device;
    over a mesh that spans processes, a LocalFrame of this rank's tiles.
    `replicas` maps a device to its copies of `inputs`, made on first use
    and reused by later frames."""
    devices = mesh.devices[f]
    ny, nx = devices.shape
    tile_h, tile_w = height // ny, width // nx
    tiles = []
    local = {}
    for r in range(ny):
        row = []
        for c in range(nx):
            if not mesh.is_local((f, r, c)):
                continue
            dev = devices[r, c]
            if dev not in replicas:
                replicas[dev] = [_replicate(a, dev) for a in inputs]
            with _TILE:
                ctx = RenderContext(
                    device=dev, width=width, height=height, opts=opts,
                    filters=program_filters, t=float(t), frame=float(frame),
                    inputs=[InputImage(pixels=a, name=f"in{i}")
                            for i, a in enumerate(replicas[dev])],
                    grid_shape=(tile_h, tile_w),
                    row_offset=r * tile_h, col_offset=c * tile_w)
                tile = render_frame(ctx, fdef, user_values(ctx, fdef, params))
            count("shard.tiles")
            row.append(tile)
            local[(r * tile_h, c * tile_w)] = tile
        tiles.append(row)
    if mesh.spans_processes:
        return LocalFrame(local, (height, width, 4))
    return assemble(tiles, devices[0, 0] if out is None else out.device, out=out)


def _check_grid(mesh, opts, width: int, height: int):
    if opts.region is not None:
        # a region render IS a tile of the canvas: render it unsharded, or
        # in place on the input-sharded path
        raise ValueError(
            "options.region is not supported by render_sharded; "
            "use render() for the region crop, or render_tiled() for "
            "the sharded-drawable selection semantics (the region "
            "rendered in place on the full canvas)")
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
    _check_grid(mesh, opts, width, height)
    return _render_tiles(mesh, 0, {}, program_filters, fdef, width, height,
                         opts, inputs, params, t, frame)


def render_frames_sharded(mesh, program_filters, fdef, width: int, height: int,
                          opts, inputs: list, params: dict, ts):
    """A sweep of len(ts) frames: frame i at t = ts[i] with its `frame`
    internal i, the frames split over the mesh's frame axis in contiguous
    blocks and each frame's grid over its slice's (y, x) tiles -> (F, H, W,
    4) on the mesh's first device. The frame count must divide by the
    frame axis. Over a mesh that spans processes, each rank renders the
    tiles of its own entries of every frame (t, `frame` and the rand()
    counters stay global) -> a LocalFrame of (F / nf, tile_h, tile_w, 4)
    frame shards keyed by their (frame, row, col) origin."""
    validate_params(fdef, params, opts.static_params)
    _check_grid(mesh, opts, width, height)
    n = len(ts)
    nf = axis_size(mesh, FRAME_AXIS)
    _check_divisible(n, nf, "num_frames")
    per_slice = n // nf
    dtype = torch.uint8 if opts.output_dtype == "uint8" else torch.float32
    replicas = {}
    if mesh.spans_processes:
        tile_h, tile_w = height // axis_size(mesh, ROW_AXIS), width // axis_size(mesh, COL_AXIS)
        shards = {(f * per_slice, r * tile_h, c * tile_w):
                  torch.empty((per_slice, tile_h, tile_w, 4), dtype=dtype,
                              device=mesh.devices[f, r, c])
                  for f, r, c in mesh.local_entries()}
        for i in range(n):
            f0 = i - i % per_slice
            with _FRAME:
                part = _render_tiles(mesh, i // per_slice, replicas, program_filters, fdef,
                                     width, height, opts, inputs, params, float(ts[i]), float(i))
            for (r0, c0), tile in part.tiles.items():
                shards[f0, r0, c0][i - f0] = tile
        return LocalFrame(shards, (n, height, width, 4))
    first = mesh.devices[0, 0, 0]
    out = torch.empty((n, height, width, 4), dtype=dtype, device=first)
    for i in range(n):
        with _FRAME:
            _render_tiles(mesh, i // per_slice, replicas, program_filters, fdef, width,
                          height, opts, inputs, params, float(ts[i]), float(i), out=out[i])
    return out
