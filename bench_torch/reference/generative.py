"""MathMap's generative Render filters, in plain PyTorch.

- mandelbrot: c = (x / X 2 / zoom + cx, y / X 2 / zoom + cy); z = 0;
  iterate z = z^2 + c while |z|^2 < 4 and iter < maxiter; a pixel that
  reached maxiter is opaque black, any other is the gradient at
  iter / maxiter. The default gradient runs from black to white, opaque,
  over 256 rows (numpy's float32 linspace), read by clamping the position
  to [0, 1], scaling by 255 and interpolating the two rows around it.
- moire: v = 1/2 + 1/2 sin(r^2 / scale + turns a + 2 pi t),
  w = 1/2 + 1/2 sin(x y / scale), gray v w.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import finish, gray, grids, lit, polar

GRADIENT_ROWS = 256


def _iterate(params, width, height, dtype, device) -> tuple:
    """-> (iteration count of every pixel, maxiter as a tensor)."""
    x, y = grids(width, height, dtype, device)
    big_x = lit(width * 0.5, dtype, device)
    two = lit(2.0, dtype, device)
    zoom = lit(params.get("zoom", 1.0), dtype, device)
    cr = x / big_x * two / zoom + lit(params.get("cx", -0.5), dtype, device)
    ci = y / big_x * two / zoom + lit(params.get("cy", 0.0), dtype, device)
    maxiter = int(params.get("maxiter", 64))
    limit = lit(float(maxiter), dtype, device)
    four = lit(4.0, dtype, device)
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(cr)
    it = torch.zeros_like(cr)
    for _ in range(maxiter):
        active = (zr * zr + zi * zi < four) & (it < limit)
        if not bool(active.any()):
            break
        nr = zr * zr - zi * zi + cr
        ni = zr * zi + zi * zr + ci
        zr = torch.where(active, nr, zr)
        zi = torch.where(active, ni, zi)
        it = torch.where(active, it + 1, it)
    return it, limit


def mandelbrot(params, t, width, height, image, dtype, device):
    it, limit = _iterate(params, width, height, dtype, device)
    ramp = torch.from_numpy(np.linspace(0.0, 1.0, GRADIENT_ROWS, dtype=np.float32))
    ramp = ramp.to(device=device, dtype=dtype)
    pos = torch.clamp(it / limit, 0.0, 1.0) * lit(GRADIENT_ROWS - 1.0, dtype, device)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.to(torch.int64).clamp(0, GRADIENT_ROWS - 1)
    i1 = (i0 + 1).clamp(max=GRADIENT_ROWS - 1)
    g = ramp[i0] + frac * (ramp[i1] - ramp[i0])
    black = torch.zeros_like(g)
    inside = it >= limit
    return finish(gray(torch.where(inside, black, g)))


def mandelbrot_iterations(params, width, height, device) -> int:
    """Loop iterations summed over every pixel, in float32: the work of
    the loop body."""
    it, _ = _iterate(params, width, height, torch.float32, device)
    return int(it.to(torch.float64).sum())


def moire(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    r, a = polar(x, y)
    half = lit(0.5, dtype, device)
    scale = lit(params.get("scale", 40.0), dtype, device)
    turns = lit(params.get("turns", 8.0), dtype, device)
    phase = lit(t, dtype, device) * lit(2.0, dtype, device) * lit(math.pi, dtype, device)
    v = half + half * torch.sin(r * r / scale + turns * a + phase)
    w = half + half * torch.sin(x * y / scale)
    return finish(gray(v * w))
