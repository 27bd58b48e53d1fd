"""origVal source-image sampling (the port of
`mathmap_tpu/runtime/sampling.py`).

The sampler's semantics (world coordinates -> pixel centres, the edge
behaviors, the interpolations) live beside the kernels: an input image
goes to kernel B1 (`kernels/sample_image.py`), a tile's halo-extended
block (`value.TiledInput`, parallel/halo.py) to kernel B4
(`kernels/sample_tiled.py`); each module holds the CUDA kernel's wrapper
and its plain PyTorch version.

An animated input is a (T, H, W, 4) stack. A scalar frame index (the
render's current frame by default) selects one frame, a view of the stack,
and the kernel samples it unchanged. A per-pixel frame grid takes the
reference's gather route (`_sample_xla` with the image's two-axis
`make_gather`), which is no Pallas kernel in the JAX package: `_sample_xla`
below ports it in plain PyTorch, on every device, the card included. It
does not call the kernels' plain versions, which stay the independent
checks of B1 and B4.

Coordinate convention: world origin at the image centre, y axis up, pixel
(row j, col i) centre at world (i + 0.5 - W/2, H/2 - 0.5 - j).
"""

from __future__ import annotations

import torch

from ..kernels.sample_image import _catmull_rom_weights, _tap, world_to_pixel
from ..kernels.sample_image import sample_image as sample_kernel
from ..kernels.sample_tiled import sample_tiled as tiled_kernel
from ..utils.constants import constant
from ..utils.trace import span

_LITERAL = span("mm.sync.literal")


def _frame_plane(ev, img, frame):
    """The frame selector of an animated input: None (a single frame, or a
    scalar frame, already applied) or an int64 grid of frame indices (a
    per-pixel frame on an input of more than one frame)."""
    if img.num_frames > 1 and isinstance(frame, torch.Tensor) and frame.dim() > 0:
        return img.frame_index(ev.grid(frame))
    return None


def _scalar_frame(ev, img, frame):
    """The frame a scalar selector names: the render's current frame when
    `frame` is None; frame 0 of a single-frame stack."""
    if img.num_frames == 1:
        return 0.0
    return ev.ctx.frame if frame is None else frame


def _sample_xla(ev, img, x, y, frames):
    """The reference's gather route for a per-pixel frame grid `frames`
    (int64) -> 4 channel grids: world coordinates to pixel centres of the
    image's global frame, the edge behavior per integer tap, then nearest,
    bilinear or Catmull-Rom bicubic taps (dx inner, dy outer), each tap
    read through `img.make_gather(frames)`."""
    opts = ev.ctx.opts
    h, w = img.global_shape
    gather = img.make_gather(frames)
    x, y = ev.grid(x), ev.grid(y)
    col = [constant(_LITERAL, float(c), torch.float32, x.device) for c in opts.edge_color]
    px, py = world_to_pixel(x, y, w, h)

    def tap(ix, iy):
        return _tap(gather, ix, iy, w, h, opts.edge_x, opts.edge_y, col)

    if opts.interpolation == "nearest":
        return tap(torch.floor(px + 0.5).to(torch.int32),
                   torch.floor(py + 0.5).to(torch.int32))
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if opts.interpolation == "bilinear":
        c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
        c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
        out = []
        for ch in range(4):
            top = c00[ch] + fx * (c10[ch] - c00[ch])
            bot = c01[ch] + fx * (c11[ch] - c01[ch])
            out.append(top + fy * (bot - top))
        return out
    wx = _catmull_rom_weights(fx)
    wy = _catmull_rom_weights(fy)
    out = [None] * 4
    for dy in range(-1, 3):
        row = [None] * 4
        for dx in range(-1, 3):
            c = tap(x0 + dx, y0 + dy)
            for ch in range(4):
                term = wx[dx + 1] * c[ch]
                row[ch] = term if row[ch] is None else row[ch] + term
        for ch in range(4):
            term = wy[dy + 1] * row[ch]
            out[ch] = term if out[ch] is None else out[ch] + term
    return out


def sample_image(ev, img, x, y, frame=None):
    """Sample an input image at world coords (x, y) with the invocation's
    interpolation and edge settings -> 4 channel grids (r, g, b, a).

    The image's device decides the route: a CUDA image goes through the
    hand-written sampler kernel, a CPU image through its plain version.
    `frame` indexes an animated input: None samples the render's current
    frame, a scalar (a Python float or 0-d tensor) selects its frame, a
    grid selects per pixel (`_sample_xla`); indices round to nearest and
    clamp to [0, T-1]."""
    opts = ev.ctx.opts
    pixels = img.pixels
    if pixels.dim() == 4:
        frames = _frame_plane(ev, img, frame)
        if frames is not None:
            return _sample_xla(ev, img, x, y, frames)
        pixels = img.frame_pixels(_scalar_frame(ev, img, frame))
    out = sample_kernel(pixels, x.contiguous(), y.contiguous(),
                        opts.interpolation, opts.edge_x, opts.edge_y,
                        opts.edge_color)
    return list(out.unbind(0))


def sample_tiled(ev, img, x, y, frame=None):
    """Sample a tile's halo-extended block (a TiledInput) at world coords
    (x, y) -> 4 channel grids. The tap's edge map is global, so every halo
    width gives the gather route's values; a set violation hook receives
    the excess of this call's taps. An animated block selects its frame as
    `sample_image` does: a scalar frame's block goes through kernel B4, a
    per-pixel frame through `_sample_xla`."""
    opts = ev.ctx.opts
    pixels = img.pixels
    if pixels.dim() == 4:
        frames = _frame_plane(ev, img, frame)
        if frames is not None:
            return _sample_xla(ev, img, x, y, frames)
        pixels = img.frame_pixels(_scalar_frame(ev, img, frame))
    gh, gw = img.global_shape
    out, excess = tiled_kernel(pixels, x.contiguous(), y.contiguous(), gh, gw, img.row_base,
                               img.col_base, bool(img.global_width), opts.interpolation,
                               opts.edge_x, opts.edge_y, opts.edge_color,
                               check=img.violation_hook is not None)
    if excess is not None:
        img.violation_hook(excess)
    return list(out.unbind(0))
