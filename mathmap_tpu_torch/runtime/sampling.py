"""origVal source-image sampling (the port of
`mathmap_tpu/runtime/sampling.py`).

The sampler's semantics (world coordinates -> pixel centres, the edge
behaviors, the interpolations) live beside the kernels: an input image
goes to kernel B1 (`kernels/sample_image.py`), a tile's halo-extended
block (`value.TiledInput`, parallel/halo.py) to kernel B4
(`kernels/sample_tiled.py`); each module holds the CUDA kernel's wrapper
and its plain PyTorch version.

Coordinate convention: world origin at the image centre, y axis up, pixel
(row j, col i) centre at world (i + 0.5 - W/2, H/2 - 0.5 - j).
"""

from __future__ import annotations

from ..kernels.sample_image import sample_image as sample_kernel
from ..kernels.sample_tiled import sample_tiled as tiled_kernel


def sample_image(ev, img, x, y, frame=None):
    """Sample an input image at world coords (x, y) with the invocation's
    interpolation and edge settings -> 4 channel grids (r, g, b, a).

    The image's device decides the route: a CUDA image goes through the
    hand-written sampler kernel, a CPU image through its plain version.
    Inputs here are single-frame, so `frame` clamps to frame 0 and is
    ignored."""
    opts = ev.ctx.opts
    out = sample_kernel(img.pixels, x.contiguous(), y.contiguous(),
                        opts.interpolation, opts.edge_x, opts.edge_y,
                        opts.edge_color)
    return list(out.unbind(0))


def sample_tiled(ev, img, x, y):
    """Sample a tile's halo-extended block (a TiledInput) at world coords
    (x, y) -> 4 channel grids. The tap's edge map is global, so every halo
    width gives the gather route's values; a set violation hook receives
    the excess of this call's taps."""
    opts = ev.ctx.opts
    gh, gw = img.global_shape
    out, excess = tiled_kernel(
        img.pixels, x.contiguous(), y.contiguous(), gh, gw, img.row_base,
        img.col_base, bool(img.global_width), opts.interpolation, opts.edge_x,
        opts.edge_y, opts.edge_color, check=img.violation_hook is not None)
    if excess is not None:
        img.violation_hook(excess)
    return list(out.unbind(0))
