"""MathMap's ripple and wave (filters/Distorts/ripple.mm, wave.mm) with
s x s grid supersampling, in plain PyTorch:

    ripple: in(xy + xy:[amplitude sin((y / wavelength + t) 2 pi),
                        amplitude sin((x / wavelength + t) 2 pi)])
    wave:   in(xy + xy:[0, amplitude sin((x / wavelength + t) 2 pi)])

A pixel's value is the mean of s x s evaluations of the filter, one at
each subsample of the pixel: subsample (i, j) (j the row, outer) sits at
dx, dy = (i + 0.5) / s - 0.5 from the pixel's centre, so its world
coordinates are x = cols + (0.5 + dx) - W/2 and y = H/2 - (rows + (0.5 +
dy)), in that order of operations. Each evaluation applies the filter's
displacement in the source's order of operations (y / wavelength, + t,
* 2, * pi, sin, amplitude *), as reference/ripple.py does, and reads the
input with origVal's bilinear sampling and a transparent edge
(reference/common.py). The samples are summed unclipped in the
subsamples' order (j outer, i inner), the sum multiplied by 1 / s^2, then
clipped to [0, 1].

Departures: none in the arithmetic. `t` arrives as the harness computes
it, float32 i / 120 for frame i of a 120-frame sweep, and becomes a 0-d
tensor of the computation's dtype, as every param does; pi is the float64
constant rounded to that dtype, as the program's literal is. wave's x
displacement, `x + 0`, is x itself and is not computed. The offsets 0.5 +
dx and 0.5 + dy and the weight 1 / s^2 are computed in float64 and
rounded to the dtype (all exact for s = 2).
"""

from __future__ import annotations

import math

import torch

from .common import finish, lit, sample_bilinear

#: the configuration's supersample (distort_anim_aa.json's `options`)
SUPERSAMPLE = 2


def offsets(s: int) -> list:
    """The (dx, dy) of the s x s subsamples, j (the row) outer."""
    return [((i + 0.5) / s - 0.5, (j + 0.5) / s - 0.5) for j in range(s) for i in range(s)]


def subsample_grids(width: int, height: int, dx: float, dy: float, dtype, device) -> tuple:
    """World (x, y) of every pixel's subsample at (dx, dy), (H, W) each."""
    cols = torch.arange(width, device=device).to(dtype)
    rows = torch.arange(height, device=device).to(dtype)
    xs = cols + lit(0.5 + dx, dtype, device) - lit(width * 0.5, dtype, device)
    ys = lit(height * 0.5, dtype, device) - (rows + lit(0.5 + dy, dtype, device))
    return (torch.broadcast_to(xs[None, :], (height, width)),
            torch.broadcast_to(ys[:, None], (height, width)))


def _phase(v, wavelength, tt, two, pi):
    return torch.sin((v / wavelength + tt) * two * pi)


def _supersampled(displace, params, defaults, t, width, height, image, dtype, device, s):
    amplitude = lit(params.get("amplitude", defaults[0]), dtype, device)
    wavelength = lit(params.get("wavelength", defaults[1]), dtype, device)
    consts = (wavelength, lit(t, dtype, device), lit(2.0, dtype, device),
              lit(math.pi, dtype, device))
    total = None
    for dx, dy in offsets(s):
        x, y = subsample_grids(width, height, dx, dy, dtype, device)
        sx, sy = displace(x, y, amplitude, consts)
        v = sample_bilinear(image, sx, sy)
        total = v if total is None else total + v
    return finish(total * lit(1.0 / (s * s), dtype, device))


def _ripple(x, y, amplitude, consts):
    return (x + amplitude * _phase(y, *consts), y + amplitude * _phase(x, *consts))


def _wave(x, y, amplitude, consts):
    return x, y + amplitude * _phase(x, *consts)


def ripple(params, t, width, height, image, dtype, device, s: int = SUPERSAMPLE):
    """ripple.mm (amplitude 5, wavelength 50 by default) at s x s."""
    return _supersampled(_ripple, params, (5.0, 50.0), t, width, height, image, dtype,
                         device, s)


def wave(params, t, width, height, image, dtype, device, s: int = SUPERSAMPLE):
    """wave.mm (amplitude 8, wavelength 40 by default) at s x s."""
    return _supersampled(_wave, params, (8.0, 40.0), t, width, height, image, dtype,
                         device, s)
