"""Halo-exchange tiled rendering: the input-sharded render over a mesh (the
port of `mathmap_tpu/parallel/halo.py`).

The input image's rows (and, on a 2-D mesh, columns) are split over the
mesh; each tile's block is extended by `halo` rows/cols taken from its ring
neighbours, and each tile renders its output block sampling only its
extended block, through kernel B4 (kernels/sample_tiled.py). The JAX
package runs this as one `shard_map` program with `ppermute`; here each
process drives the tiles it owns: a tile's tensors live on its device, a
neighbour block on the same process gives its halo as a slice moved with
`.to(device, non_blocking=True)` (a copy within HBM when both tiles are on
one card, a peer copy across cards), and over a mesh that spans processes
(parallel/distributed.global_mesh) a neighbour on another rank sends it
(distributed.exchange, the counterpart of `ppermute`), so no process holds
another's blocks and no device the whole canvas. An animated input's
frames are all split and exchanged alike, so a tile samples the block of
the frame it selects.

With `RenderOptions.region` (a GIMP selection of a drawable too large to
replicate) the output is the FULL canvas: each tile evaluates only its
exact overlap with the selection, at the overlap's global offset (tiles
without one evaluate nothing), and every other pixel passes through from
input 0's current frame. The reference evaluates a uniform clamped window
on every device instead, because `shard_map` needs one shape everywhere;
its wider window can trip the halo check on pixels outside the selection,
where this one renders.

Correctness contract: the filter's source displacement must be bounded by
`halo` rows (and cols, when column-sharded). Three layers, as in the
reference:
  - halo="auto" infers the bound from the filter AST (parallel/bounds.py)
    and sizes the halo;
  - check=True (default) measures, per sampler call outside a while
    loop's steps (a loop's probe is measured), how far past the block any
    tap reached and raises MMRuntimeError on a violation instead of
    clamping silently (one device sync per render; over ranks, a max
    reduction first, so every rank raises alike);
  - out-of-halo taps clamp into the block when check=False.
"""

from __future__ import annotations

import math

import torch

from ..kernels.finish_rgba import pack_uint8
from ..kernels.sample_image import u8_to_float
from ..runtime.render import (float_inputs, render_frame, resolve_region, user_values,
                              validate_params)
from ..runtime.tracer import RenderContext
from ..runtime.value import InputImage, TiledInput
from ..utils.errors import MMRuntimeError
from ..utils.trace import span
from .bounds import infer_displacement_bound
from .distributed import all_reduce_max, exchange
from .mesh import COL_AXIS, ROW_AXIS, assemble, axis_size
from .shard import LocalFrame

#: a rank's halo excess when its tiles measured no sample (the reference's
#: initial excess): below any real excess, so the reduction ignores it
NO_SAMPLE = -(2 ** 30)


def exchange_halo(blocks: list, halo: int, axis: int = 0) -> list:
    """Extend each block of one mesh axis's ring, every block in this
    process, with `halo` rows (axis=0) or cols (axis=1) from its ring
    neighbours -> the list of blocks extended by 2*halo along `axis`
    (exchange_rings over the one ring)."""
    return exchange_rings([blocks], halo, axis)[0]


def exchange_rings(rings: list, halo: int, axis: int = 0, owners=None, rank: int = 0) -> list:
    """One exchange phase: extend each block of every ring with `halo`
    rows (axis=0) or cols (axis=1) from its ring neighbours -> the rings
    of blocks extended by 2*halo along `axis`, each on its own block's
    device. At the global edges the halo wraps around the ring (right for
    edge 'wrap'; _paint_edge_halo rewrites it for 'color' and 'reflect').
    halo == 0 means no exchange at all.

    `rings`: lists of blocks in ring order, None where another rank owns
    the entry; `owners`: per ring, the rank that owns each position (None:
    this process owns every block). A neighbour here is a slice moved with
    `.to(device)`; a neighbour on another rank sends its slice through
    distributed.exchange, every message of the phase posted at once, in
    the order (ring, position, leading then trailing halo) that every rank
    enumerates alike."""
    if halo == 0:
        return [list(ring) for ring in rings]
    if halo < 0:
        raise MMRuntimeError(f"halo must be >= 0, got {halo}")
    pieces = {}
    sends, recvs, received = [], [], []
    for k, ring in enumerate(rings):
        n = len(ring)
        for i in range(n):
            # the previous block's trailing rows lead block i; the next
            # block's leading rows trail it
            for side, j in ((0, (i - 1) % n), (1, (i + 1) % n)):
                src = rank if owners is None else owners[k][j]
                dst = rank if owners is None else owners[k][i]
                if src == rank:
                    b = ring[j]
                    piece = b.narrow(axis, b.shape[axis] - halo if side == 0 else 0, halo)
                    if dst == rank:
                        pieces[k, i, side] = piece.to(ring[i].device, non_blocking=True)
                    else:
                        sends.append((dst, piece))
                elif dst == rank:
                    shape = list(ring[i].shape)
                    shape[axis] = halo
                    recvs.append((src, tuple(shape), ring[i].dtype, ring[i].device))
                    received.append((k, i, side))
    if sends or recvs:
        pieces.update(zip(received, exchange(sends, recvs)))
    return [[None if b is None else
             torch.cat([pieces[k, i, 0], b, pieces[k, i, 1]], dim=axis)
             for i, b in enumerate(ring)] for k, ring in enumerate(rings)]


def _paint_edge_halo(ext, axis_idx: int, n_axis: int, halo: int, axis: int,
                     behavior: str, edge_color):
    """A global-edge tile's ring-wrapped halo holds the OPPOSITE global
    edge's rows. Under edge 'color'/'reflect', overwrite (in place) the
    leading halo of tile 0 and the trailing halo of tile n-1 with what the
    global edge semantics put at global positions [-halo, 0) / [N, N+halo):
    the edge color, or the mirror of the tile's own boundary rows ('wrap'
    keeps the ring content, which IS the wrap semantics). Kernel B4
    edge-maps every tap globally, so in-contract taps never read these
    rows; with check=False a violating tap clamped into the block may, and
    then reads what the reference's block holds there."""
    ext_n = ext.shape[axis]
    lead = ext.narrow(axis, 0, halo) if axis_idx == 0 else None
    trail = ext.narrow(axis, ext_n - halo, halo) if axis_idx == n_axis - 1 else None
    if behavior == "color":
        with span("mm.sync.literal"):
            col = torch.tensor(edge_color, dtype=ext.dtype, device=ext.device)
        for part in (lead, trail):
            if part is not None:
                part.copy_(col.expand_as(part))
        return
    # reflect: global position -k mirrors to k-1, so local halo row i takes
    # local row 2*halo-1-i; the trailing halo mirrors across ext_n - halo.
    # The sources lie in the tile's own rows, which no paint writes.
    lead_src = ext.narrow(axis, halo, halo).flip(axis) if lead is not None else None
    trail_src = (ext.narrow(axis, ext_n - 2 * halo, halo).flip(axis)
                 if trail is not None else None)
    for part, src in ((lead, lead_src), (trail, trail_src)):
        if part is not None:
            part.copy_(src)


def auto_halo(program_filters, fdef, width: int, height: int,
              opts, params=None, ny: int = 2, nx: int = 2):
    """(halo_rows, halo_cols) from the static displacement bound, or raises
    MMRuntimeError when the filter's displacement is unbounded/unknown.
    ny/nx: mesh extent per axis; an axis of one tile exchanges no halo, so
    its displacement bound is irrelevant."""
    bound = infer_displacement_bound(program_filters, fdef, width, height, params)
    if bound is not None:
        bound = (bound[0] if ny > 1 else 0.0, bound[1] if nx > 1 else 0.0)
    if bound is None or bound[0] >= height or bound[1] >= width:
        raise MMRuntimeError(
            f"cannot infer a usable displacement bound for filter "
            f"{fdef.name!r} ({'unbounded' if bound is None else f'bound {bound}'}"
            f" at {width}x{height}): pass an explicit halo= (or render "
            f"unsharded)")
    dy, dx = bound
    # interpolation taps extend up to 2 texels past the displaced floor
    # (bicubic); +1 covers the pixel-center half-texel
    margin = {"nearest": 1, "bilinear": 2, "bicubic": 3}[opts.interpolation]
    return int(math.ceil(dy)) + margin, int(math.ceil(dx)) + margin


def _overlap(region, r0: int, c0: int, tile_h: int, tile_w: int):
    """The (row, col, rows, cols) of a tile's overlap with `region`, in
    global pixels, or None when they do not meet."""
    x, y, w, h = region
    top, left = max(y, r0), max(x, c0)
    bottom, right = min(y + h, r0 + tile_h), min(x + w, c0 + tile_w)
    if top >= bottom or left >= right:
        return None
    return top, left, bottom - top, right - left


def _background(block: torch.Tensor, opts, frame: float):
    """A region render's pass-through: input 0's current frame over one
    tile, from its block, in the output dtype, as a fresh tensor on the
    block's device. u8 in and u8 out copy the input bytes; otherwise the
    float values are packed, or u8 is converted, by the render's own
    rules."""
    block = InputImage(pixels=block).frame_pixels(frame)
    if opts.output_dtype == "uint8":
        return block.clone() if block.dtype == torch.uint8 else pack_uint8(block)
    return u8_to_float(block) if block.dtype == torch.uint8 else block.clone()


def _block(a, r: int, c: int, tile_h: int, tile_w: int, device) -> torch.Tensor:
    """Tile (r, c)'s own block of input `a` on `device`, in its dtype: a
    slice of a whole (H, W, 4) or animated (T, H, W, 4) tensor, or the
    tile of a shard.LocalFrame rendered over the same tiling."""
    if isinstance(a, LocalFrame):
        tile = a.tiles.get((r * tile_h, c * tile_w))
        if tile is None or tuple(tile.shape) != (tile_h, tile_w, 4):
            raise ValueError(
                f"a LocalFrame input must hold this rank's tiles of the same mesh tiling: "
                f"no ({tile_h}, {tile_w}, 4) tile at ({r * tile_h}, {c * tile_w})")
        return tile.to(device, non_blocking=True)
    return a[..., r * tile_h:(r + 1) * tile_h, c * tile_w:(c + 1) * tile_w, :].to(
        device, non_blocking=True)


def render_frame_tiled(mesh, program_filters, fdef, width: int, height: int,
                       opts, inputs: list, halo, params: dict, t: float = 0.0,
                       frame: float = 0.0, check: bool = True):
    """One frame with every input split over the mesh's (y, x) axes and
    halo-exchanged -> (the (H, W, 4) frame on the mesh's first device, the
    largest halo excess as a 0-d int32 tensor there, or None when check is
    False or no sample was measured).

    inputs: (H, W, 4) float32 or uint8 tensors, one per image parameter,
    each of the output's geometry (one halo serves all: the displacement
    bound covers every sample); an animated (T, H, W, 4) input shards and
    exchanges every frame alike. halo: int (rows; cols too when
    column-sharded) or (rows, cols). The tiles are those of the mesh's
    first frame slice. With opts.region, the frame is the full canvas with
    the selection rendered in place and input 0's current frame elsewhere
    (see the module docstring).

    Over a mesh that spans processes this rank stages and renders only its
    own tiles: an input is a tensor every rank passes alike (whole, on the
    host or a device; only this rank's blocks are copied to its devices)
    or a shard.LocalFrame of an earlier render over the same tiling. The
    halo crosses ranks through distributed.exchange, and with check=True
    the excess is reduced over the ranks (every rank takes part, with the
    reference's sentinel -2**30 when its tiles measured no sample). ->
    (a shard.LocalFrame of this rank's tiles, that excess on the host
    under gloo, or None when check is False)."""
    devices = mesh.devices[0]
    ny, nx = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    if height % ny:
        raise MMRuntimeError(f"height ({height}) must be divisible by mesh rows ({ny})")
    if width % nx:
        raise MMRuntimeError(f"width ({width}) must be divisible by mesh cols ({nx})")
    tile_h, tile_w = height // ny, width // nx
    halo_y, halo_x = halo if isinstance(halo, tuple) else (halo, halo)
    if halo_y < 0 or halo_x < 0:
        raise MMRuntimeError(f"halo must be >= 0, got {halo!r}")
    if halo_y > tile_h:
        raise MMRuntimeError(f"halo ({halo_y}) larger than tile height ({tile_h})")
    if nx > 1 and halo_x > tile_w:
        raise MMRuntimeError(f"halo ({halo_x}) larger than tile width ({tile_w})")
    if nx == 1:
        halo_x = 0
    region = resolve_region(opts, width, height)
    if region is not None and not inputs:
        raise MMRuntimeError(
            "region on the tiled path needs at least one input: input 0 "
            "is the drawable whose unselected pixels pass through")
    local = [(r, c) for _f, r, c in mesh.local_entries(0)]
    col_rings = [[(r, c) for r in range(ny)] for c in range(nx)]
    row_rings = [[(r, c) for c in range(nx)] for r in range(ny)]

    def phase(blocks, rings, n_halo, axis):
        owners = ([[mesh.owner((0, *rc)) for rc in ring] for ring in rings]
                  if mesh.spans_processes else None)
        ext = exchange_rings([[blocks.get(rc) for rc in ring] for ring in rings], n_halo,
                             axis, owners, mesh.rank)
        return {rc: b for ring, row in zip(rings, ext) for rc, b in zip(ring, row)
                if b is not None}

    # per input: this rank's blocks as float32 on their tiles' devices,
    # exchange rows, paint, then exchange columns and paint (the
    # reference's order); an animated block's row and column axes follow
    # its frame axis
    blocks_per_input = []
    background = {}
    for k, a in enumerate(inputs):
        ax0 = a.dim() - 3 if isinstance(a, torch.Tensor) else 0
        raw = {(r, c): _block(a, r, c, tile_h, tile_w, devices[r, c]) for r, c in local}
        if k == 0 and region is not None:
            background = raw
        blocks = dict(zip(raw, float_inputs(list(raw.values()))))
        blocks = phase(blocks, col_rings, halo_y, ax0)
        if halo_y and opts.edge_y in ("color", "reflect"):
            for (r, c), b in blocks.items():
                _paint_edge_halo(b, r, ny, halo_y, ax0, opts.edge_y, opts.edge_color)
        if nx > 1:
            blocks = phase(blocks, row_rings, halo_x, ax0 + 1)
            if halo_x and opts.edge_x in ("color", "reflect"):
                for (r, c), b in blocks.items():
                    _paint_edge_halo(b, c, nx, halo_x, ax0 + 1, opts.edge_x,
                                     opts.edge_color)
        blocks_per_input.append({rc: b.contiguous() for rc, b in blocks.items()})

    first = mesh.first_local
    excess = []
    tiles = {}
    for r, c in local:
        r0, c0 = r * tile_h, c * tile_w
        grid = (r0, c0, tile_h, tile_w)
        if region is not None:
            bg = _background(background[r, c], opts, frame)
            grid = _overlap(region, r0, c0, tile_h, tile_w)
            if grid is None:
                tiles[r0, c0] = bg
                continue
        gy, gx, gh, gw = grid
        ctx = RenderContext(
            device=devices[r, c], width=width, height=height, opts=opts,
            filters=program_filters, t=float(t), frame=float(frame),
            grid_shape=(gh, gw), row_offset=gy, col_offset=gx)

        def hook(e, ctx=ctx):
            # samples inside while loops are not checked, as in the
            # reference (whose traced excess cannot leave the loop)
            if ctx.loop_depth == 0:
                excess.append(e.to(first, non_blocking=True))

        ctx.inputs = [TiledInput(
            pixels=ext[r, c], name=f"in{k}",
            global_height=height, global_width=width if nx > 1 else 0,
            row_base=r0 - halo_y,
            col_base=c0 - halo_x if nx > 1 else 0,
            halo_y=halo_y, halo_x=halo_x,
            violation_hook=hook if check else None)
            for k, ext in enumerate(blocks_per_input)]
        out = render_frame(ctx, fdef, user_values(ctx, fdef, params))
        if region is not None:
            bg[gy - r0:gy - r0 + gh, gx - c0:gx - c0 + gw] = out
            out = bg
        tiles[r0, c0] = out
    worst = torch.stack(excess).max() if excess else None
    if mesh.spans_processes:
        if check:
            if worst is None:
                with span("mm.sync.literal"):
                    worst = torch.tensor(NO_SAMPLE, dtype=torch.int32, device=first)
            worst = all_reduce_max(worst)
        return LocalFrame(tiles, (height, width, 4)), worst
    return assemble([[tiles[r * tile_h, c * tile_w] for c in range(nx)] for r in range(ny)],
                    first), worst


class TiledRenderer:
    """The input-sharded renderer of one configuration.

    halo: int, (rows, cols), or "auto" (static displacement inference).
    check=True raises MMRuntimeError when any sample outside a loop's steps
    reached beyond the halo. opts.region renders the selection in place on
    the full canvas; supersample_scheme="corners" is refused, as in the
    reference (its corner row and column would need their own halo). Over
    a mesh that spans processes every rank calls it alike (the same
    params, halo and check): a call gives this rank's shard.LocalFrame,
    and a violation anywhere raises the same error on every rank."""

    def __init__(self, mesh, program_filters, fdef, width: int, height: int,
                 opts, halo, params=None, check: bool = True):
        self.params = dict(params or {})
        validate_params(fdef, self.params, opts.static_params)
        resolve_region(opts, width, height)
        if opts.supersample > 1 and opts.supersample_scheme == "corners":
            raise ValueError(
                "supersample_scheme='corners' is not supported by the "
                "tiled (input-sharded) renderer; use 'grid'")
        if halo == "auto":
            halo = auto_halo(program_filters, fdef, width, height, opts,
                             self.params, ny=axis_size(mesh, ROW_AXIS),
                             nx=axis_size(mesh, COL_AXIS))
        self.halo = halo
        self.check = check
        self.mesh = mesh
        self.config = (program_filters, fdef, width, height, opts)

    def __call__(self, inputs: list, t: float = 0.0, frame: float = 0.0):
        out, excess = render_frame_tiled(
            self.mesh, *self.config, inputs, self.halo, self.params, t=t,
            frame=frame, check=self.check)
        if excess is not None:
            with span("mm.sync.readback"):
                worst = int(excess)  # the render's one sync
            if worst > 0:
                raise MMRuntimeError(
                    f"tiled render violated the bounded-displacement contract: "
                    f"a sample reached {worst} texel(s) beyond the halo "
                    f"{self.halo}; increase halo= or render unsharded")
        return out
