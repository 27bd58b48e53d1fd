"""MathMap's coordinate system and origVal sampling in plain PyTorch.

- Pixel (row j, column i) of a W x H frame has its centre at world
  x = i + 0.5 - W/2, y = H/2 - 0.5 - j (y up); X = W/2, Y = H/2,
  R = sqrt(X^2 + Y^2); r = sqrt(x^2 + y^2), a = atan2(y, x) in [0, 2 pi).
- origVal at world (x, y) of a w x h image reads pixel centres
  px = x + w/2 - 0.5, py = h/2 - 0.5 - y; bilinear interpolation of the
  four taps around them; a tap outside the image is the edge colour,
  transparent black. A uint8 value v reads as v / 255.

Constants are 0-d tensors of the computation's dtype, so a division is
the correctly rounded one on every device.
"""

from __future__ import annotations

import math

import torch


def lit(v: float, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def grids(width: int, height: int, dtype, device) -> tuple:
    cols = torch.arange(width, device=device).to(dtype)
    rows = torch.arange(height, device=device).to(dtype)
    xs = cols + lit(0.5, dtype, device) - lit(width * 0.5, dtype, device)
    ys = lit(height * 0.5, dtype, device) - (rows + lit(0.5, dtype, device))
    return (torch.broadcast_to(xs[None, :], (height, width)),
            torch.broadcast_to(ys[:, None], (height, width)))


def polar(x: torch.Tensor, y: torch.Tensor) -> tuple:
    r = torch.sqrt(x * x + y * y)
    a = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    return r, a


def corner_radius(width: int, height: int) -> float:
    return ((width * 0.5) ** 2 + (height * 0.5) ** 2) ** 0.5


def sample_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """origVal(x, y) of the uint8 (h, w, 4) `image` -> (H, W, 4) in x's
    dtype, the edge colour transparent black."""
    dtype, dev = x.dtype, x.device
    h, w = int(image.shape[0]), int(image.shape[1])
    src = image.to(dtype) / lit(255.0, dtype, dev)
    px = x + lit(w * 0.5 - 0.5, dtype, dev)
    py = lit(h * 0.5 - 0.5, dtype, dev) - y
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0f)[..., None], (py - y0f)[..., None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = src[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, torch.zeros((), dtype=dtype, device=dev))

    c00, c10 = tap(x0, y0), tap(x0 + 1, y0)
    top = c00 + fx * (c10 - c00)
    del c00, c10
    c01, c11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    bot = c01 + fx * (c11 - c01)
    return top + fy * (bot - top)


def gray(g: torch.Tensor) -> torch.Tensor:
    return torch.stack([g, g, g, torch.ones_like(g)], dim=-1)


def finish(rgba: torch.Tensor) -> torch.Tensor:
    return torch.clamp(rgba, 0.0, 1.0)
