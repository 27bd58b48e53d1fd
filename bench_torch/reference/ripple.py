"""MathMap's ripple (filters/Distorts/ripple.mm) in plain PyTorch: the
input read at the pixel displaced by a sine of the other axis, moving with
t,

    in(xy + xy:[amplitude sin((y / wavelength + t) 2 pi),
                amplitude sin((x / wavelength + t) 2 pi)])

in the source's order of operations (y / wavelength, + t, * 2, * pi, sin,
amplitude *), with origVal's bilinear sampling and a transparent edge
(reference/common.py). The whole frame is computed on one device: the
reference knows nothing of meshes or tiles.

Departures: none in the arithmetic. `t` arrives as the harness computes
it, float32 i / 119 for frame i of a 120-frame sweep, and becomes a 0-d
tensor of the computation's dtype, as every param does; pi is the float64
constant rounded to that dtype, as the program's literal is.
"""

from __future__ import annotations

import math

import torch

from .common import finish, grids, lit, sample_bilinear


def ripple(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    amplitude = lit(params.get("amplitude", 5.0), dtype, device)
    wavelength = lit(params.get("wavelength", 50.0), dtype, device)
    tt = lit(t, dtype, device)
    two, pi = lit(2.0, dtype, device), lit(math.pi, dtype, device)
    dx = amplitude * torch.sin((y / wavelength + tt) * two * pi)
    dy = amplitude * torch.sin((x / wavelength + tt) * two * pi)
    return finish(sample_bilinear(image, x + dx, y + dy))
