"""Whole-image filters that filter code calls as builtins (the port of
`mathmap_tpu/runtime/native_filters.py`): the gaussian blur.

`gaussian_blur(image, stddev)` blurs a whole image once and returns it as
an image value, which the filter then samples like any input. The blur is
separable, with radius ceil(3 stddev), over zero padding, renormalised by
the blur of the image's mask, so the border keeps its brightness. It runs
as the reference's NumPy oracle runs it, one shifted-slice multiply and
add per tap and axis, in the oracle's order, on every device: the float32
result is the oracle's bit for bit on the CPU, and a cuDNN convolution
(TF32 by default on Hopper) is not used. The JAX package computes it with
`lax.conv_general_dilated`, outside any Pallas kernel, so no hand-written
kernel replaces it. A render caches each blur by its source tensor.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..kernels.sample_image import u8_to_float
from ..utils.errors import MMRuntimeError, MMTypeError
from .value import InputImage, TiledInput, image_value


def gauss_kernel(stddev: float, radius: int) -> list:
    """The normalised taps, computed in float64 and rounded to float32 as
    the oracle does, as Python floats."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / stddev) ** 2)
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def blur_radius(stddev: float) -> tuple:
    """(stddev, radius) as the oracle clamps them."""
    stddev = max(float(stddev), 1e-3)
    return stddev, max(1, int(math.ceil(3.0 * stddev)))


def _shifted_sum(padded, taps, n: int, dim: int):
    """sum_i taps[i] * padded[i : i + n] along `dim`, accumulated in tap
    order."""
    out = torch.zeros_like(padded.narrow(dim, 0, n))
    for i, kv in enumerate(taps):
        out += padded.narrow(dim, i, n) * kv
    return out


def gaussian_blur_pixels(pixels: torch.Tensor, stddev: float) -> torch.Tensor:
    """Separable gaussian blur of an (H, W, 4) image (uint8 images are
    normalised by /255 first) -> float32 (H, W, 4); an animated (T, H, W, 4)
    stack blurs frame by frame."""
    if pixels.dim() == 4:
        return torch.stack([gaussian_blur_pixels(f, stddev) for f in pixels])
    img = u8_to_float(pixels) if pixels.dtype == torch.uint8 else pixels.to(torch.float32)
    stddev, radius = blur_radius(stddev)
    k = gauss_kernel(stddev, radius)
    h, w, _ = img.shape
    # along x: every row has the same mask, so one row of it serves all
    padded = img.new_zeros((h, w + 2 * radius, 4))
    padded[:, radius:radius + w] = img
    mask = img.new_zeros((1, w + 2 * radius))
    mask[:, radius:radius + w] = 1.0
    outx = _shifted_sum(padded, k, w, 1)
    mx = _shifted_sum(mask, k, w, 1)
    # along y
    padded = img.new_zeros((h + 2 * radius, w, 4))
    padded[radius:radius + h] = outx
    masky = img.new_zeros((h + 2 * radius, w))
    masky[radius:radius + h] = mx
    out = _shifted_sum(padded, k, h, 0)
    my = _shifted_sum(masky, k, h, 0)
    return out / my[:, :, None]


def native_gaussian_blur(ev, img_value, stddev_value, span):
    """The builtin: gaussian_blur(image, stddev) -> image."""
    if img_value.tag != "image":
        raise MMTypeError("'gaussian_blur' expects an image argument", span)
    base = img_value.payload
    if type(base) is TiledInput:
        # a tile's halo-extended block is not the image: blurring it would
        # lose its global placement, and no halo is sized for the radius
        raise MMRuntimeError(
            "'gaussian_blur' is not supported under tiled/halo rendering "
            "— render unsharded or shard by frames", span)
    if not isinstance(base, InputImage):
        # a closure image is rasterised over the output grid first: in a
        # stacked walk of subsamples (runtime/render.py), over one
        # subsample's (h, w) grid at the pixel centres, as a per-walk frame
        # rasterises it, so the blur matches it bit for bit
        from .render import coordinate_grids
        from .tracer import Evaluator

        ctx = ev.ctx
        if ctx.stacked > 1:
            h, w = ctx.shape
            ctx = replace(ctx, grid_shape=(h // ctx.stacked, w), stacked=1)
        x, y = coordinate_grids(ctx)
        if ctx is not ev.ctx:
            ev = Evaluator(ctx, x, y, ev.env, ev.salt_extra)
        comps = base.sample(ev, x, y)
        base = InputImage(pixels=torch.stack([ev.grid(c) for c in comps], dim=-1),
                          name="rasterized")
    # the radius is a shape, so the stddev must be known before the render
    stddev = stddev_value.static_scalar()
    if stddev is None:
        raise MMRuntimeError(
            "'gaussian_blur' needs a trace-time-constant stddev (a "
            "literal, a param default, or a param listed in "
            "static_params/--static-params) — the kernel radius is a "
            "static shape", span)
    key = (id(base.pixels), round(stddev, 6))
    cache = ev.ctx.native_cache
    ent = cache.get(key)
    # the entry pins its source tensor: an id() can be reused once the
    # tensor is freed
    if ent is None or ent[0] is not base.pixels:
        ent = cache[key] = (base.pixels, InputImage(
            pixels=gaussian_blur_pixels(base.pixels, stddev), name=f"blur({base.name})"))
    return image_value(ent[1])
