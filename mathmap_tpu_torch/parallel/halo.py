"""Halo-exchange tiled rendering: the input-sharded render over a mesh (the
port of `mathmap_tpu/parallel/halo.py`).

The input image's rows (and, on a 2-D mesh, columns) are split over the
mesh; each tile's block is extended by `halo` rows/cols taken from its ring
neighbours, and each tile renders its output block sampling only its
extended block, through kernel B4 (kernels/sample_tiled.py). The JAX
package runs this as one `shard_map` program with `ppermute`; here one
process drives every tile: a tile's tensors live on its device, and the
halo exchange is a slice of the neighbour's block moved with
`.to(device, non_blocking=True)` (a copy within HBM when both tiles are on
one card, a peer copy across cards). An animated input's frames are all
split and exchanged alike, so a tile samples the block of the frame it
selects.

Correctness contract: the filter's source displacement must be bounded by
`halo` rows (and cols, when column-sharded). Three layers, as in the
reference:
  - halo="auto" infers the bound from the filter AST (parallel/bounds.py)
    and sizes the halo;
  - check=True (default) measures, per sampler call outside a while
    loop's steps (a loop's probe is measured), how far past the block any
    tap reached and raises MMRuntimeError on a violation instead of
    clamping silently (one device sync per render);
  - out-of-halo taps clamp into the block when check=False.
"""

from __future__ import annotations

import math

import torch

from ..runtime.render import float_inputs, render_frame, user_values, validate_params
from ..runtime.tracer import RenderContext
from ..runtime.value import TiledInput
from ..utils.errors import MMRuntimeError
from .bounds import infer_displacement_bound
from .mesh import COL_AXIS, ROW_AXIS, assemble, axis_size


def exchange_halo(blocks: list, halo: int, axis: int = 0) -> list:
    """Extend each block of one mesh axis's ring with `halo` rows (axis=0)
    or cols (axis=1) from its ring neighbours -> the list of blocks
    extended by 2*halo along `axis`, each on its own block's device. At
    the global edges the halo wraps around the ring (right for edge
    'wrap'; _paint_edge_halo rewrites it for 'color' and 'reflect').
    halo == 0 means no exchange at all."""
    if halo == 0:
        return list(blocks)
    if halo < 0:
        raise MMRuntimeError(f"halo must be >= 0, got {halo}")
    n = len(blocks)
    out = []
    for i, block in enumerate(blocks):
        before, after = blocks[(i - 1) % n], blocks[(i + 1) % n]
        # the previous block's trailing rows lead this one; the next
        # block's leading rows trail it
        lead = before.narrow(axis, before.shape[axis] - halo, halo)
        trail = after.narrow(axis, 0, halo)
        out.append(torch.cat([lead.to(block.device, non_blocking=True), block,
                              trail.to(block.device, non_blocking=True)], dim=axis))
    return out


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


def render_frame_tiled(mesh, program_filters, fdef, width: int, height: int,
                       opts, inputs: list, halo, params: dict, t: float = 0.0,
                       frame: float = 0.0, check: bool = True):
    """One frame with every input split over the mesh's (y, x) axes and
    halo-exchanged -> ((H, W, 4) frame on the mesh's first device, the
    largest halo excess as a 0-d int32 tensor there, or None when check is
    False or no sample was measured).

    inputs: (H, W, 4) float32 or uint8 tensors, one per image parameter,
    each of the output's geometry (one halo serves all: the displacement
    bound covers every sample); an animated (T, H, W, 4) input shards and
    exchanges every frame alike. halo: int (rows; cols too when
    column-sharded) or (rows, cols). The tiles are those of the mesh's
    first frame slice."""
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

    # per input: convert to float32 on the tile's device, exchange rows,
    # paint, then exchange columns and paint (the reference's order); an
    # animated block's row and column axes follow its frame axis
    blocks_per_input = []
    for a in inputs:
        ax0 = a.dim() - 3
        blocks = [float_inputs([a[..., r * tile_h:(r + 1) * tile_h,
                                  c * tile_w:(c + 1) * tile_w, :]
                                .to(devices[r, c], non_blocking=True) for c in range(nx)])
                  for r in range(ny)]
        for c in range(nx):
            col = exchange_halo([blocks[r][c] for r in range(ny)], halo_y, axis=ax0)
            for r in range(ny):
                blocks[r][c] = col[r]
                if halo_y and opts.edge_y in ("color", "reflect"):
                    _paint_edge_halo(blocks[r][c], r, ny, halo_y, ax0, opts.edge_y,
                                     opts.edge_color)
        if nx > 1:
            for r in range(ny):
                blocks[r] = exchange_halo(blocks[r], halo_x, axis=ax0 + 1)
                if halo_x and opts.edge_x in ("color", "reflect"):
                    for c in range(nx):
                        _paint_edge_halo(blocks[r][c], c, nx, halo_x, ax0 + 1, opts.edge_x,
                                         opts.edge_color)
        blocks_per_input.append([[b.contiguous() for b in row] for row in blocks])

    first = devices[0, 0]
    excess = []
    tiles = []
    for r in range(ny):
        row = []
        for c in range(nx):
            ctx = RenderContext(
                device=devices[r, c], width=width, height=height, opts=opts,
                filters=program_filters, t=float(t), frame=float(frame),
                grid_shape=(tile_h, tile_w),
                row_offset=r * tile_h, col_offset=c * tile_w)

            def hook(e, ctx=ctx):
                # samples inside while loops are not checked, as in the
                # reference (whose traced excess cannot leave the loop)
                if ctx.loop_depth == 0:
                    excess.append(e.to(first, non_blocking=True))

            ctx.inputs = [TiledInput(
                pixels=ext[r][c], name=f"in{k}",
                global_height=height, global_width=width if nx > 1 else 0,
                row_base=r * tile_h - halo_y,
                col_base=c * tile_w - halo_x if nx > 1 else 0,
                halo_y=halo_y, halo_x=halo_x,
                violation_hook=hook if check else None)
                for k, ext in enumerate(blocks_per_input)]
            row.append(render_frame(ctx, fdef, user_values(ctx, fdef, params)))
        tiles.append(row)
    worst = torch.stack(excess).max() if excess else None
    return assemble(tiles, first), worst


class TiledRenderer:
    """The input-sharded renderer of one configuration.

    halo: int, (rows, cols), or "auto" (static displacement inference).
    check=True raises MMRuntimeError when any sample outside a loop's steps
    reached beyond the halo. (`region` and supersample_scheme="corners"
    cannot reach it: RenderOptions refuses them, ROADMAP A4c.)"""

    def __init__(self, mesh, program_filters, fdef, width: int, height: int,
                 opts, halo, params=None, check: bool = True):
        self.params = dict(params or {})
        validate_params(fdef, self.params, opts.static_params)
        if halo == "auto":
            halo = auto_halo(program_filters, fdef, width, height, opts,
                             self.params, ny=axis_size(mesh, ROW_AXIS),
                             nx=axis_size(mesh, COL_AXIS))
        self.halo = halo
        self.check = check
        self.mesh = mesh
        self.config = (program_filters, fdef, width, height, opts)

    def __call__(self, inputs: list, t: float = 0.0, frame: float = 0.0) -> torch.Tensor:
        out, excess = render_frame_tiled(
            self.mesh, *self.config, inputs, self.halo, self.params, t=t,
            frame=frame, check=self.check)
        if excess is not None:
            worst = int(excess)  # the render's one sync
            if worst > 0:
                raise MMRuntimeError(
                    f"tiled render violated the bounded-displacement contract: "
                    f"a sample reached {worst} texel(s) beyond the halo "
                    f"{self.halo}; increase halo= or render unsharded")
        return out
