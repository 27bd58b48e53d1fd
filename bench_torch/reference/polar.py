"""The polar distortions of MathMap's Distorts library, in plain PyTorch:
each maps the pixel's (r, a) to new polar coordinates and reads the input
there with origVal's bilinear sampling.

- fisheye: r' = R (r / R)^strength
- twirl:   a' = a + angle (1 - r / R)^2
- pond:    r' = r + amplitude sin(r / wavelength 2 pi + phase)
"""

from __future__ import annotations

import math

import torch

from .common import corner_radius, finish, grids, lit, polar, sample_bilinear


def _warp(image, r2, a2):
    return finish(sample_bilinear(image, r2 * torch.cos(a2), r2 * torch.sin(a2)))


def fisheye(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    r, a = polar(x, y)
    big_r = lit(corner_radius(width, height), dtype, device)
    strength = lit(params.get("strength", 2.0), dtype, device)
    return _warp(image, big_r * torch.pow(r / big_r, strength), a)


def twirl(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    r, a = polar(x, y)
    big_r = lit(corner_radius(width, height), dtype, device)
    angle = lit(params.get("angle", 3.0), dtype, device)
    fall = torch.pow(lit(1.0, dtype, device) - r / big_r, lit(2.0, dtype, device))
    return _warp(image, r, a + angle * fall)


def pond(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    r, a = polar(x, y)
    amplitude = lit(params.get("amplitude", 5.0), dtype, device)
    wavelength = lit(params.get("wavelength", 20.0), dtype, device)
    phase = lit(params.get("phase", 0.0), dtype, device)
    arg = r / wavelength * lit(2.0, dtype, device) * lit(math.pi, dtype, device) + phase
    return _warp(image, r + amplitude * torch.sin(arg), a)
