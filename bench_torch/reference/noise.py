"""MathMap's Perlin-noise and cellular filters, in plain PyTorch.

- `perlin`: Ken Perlin's improved noise ("Improving Noise", SIGGRAPH
  2002), as his `ImprovedNoise` reference computes it: the lattice cell
  floor(x) & 255 per axis, the fractions x - floor(x), the fade curve
  6t^5 - 15t^4 + 10t^3, the doubled 256-entry permutation P hashing the
  eight corners (A = P[X] + Y, AA = P[A] + Z, AB = P[A + 1] + Z,
  B = P[X + 1] + Y, BA = P[B] + Z, BB = P[B + 1] + Z), the 12-gradient
  `grad` on the hash's low four bits, and seven lerps: four along x, two
  along y, one along z, in the published order.
- turbulence: v = noise(x / scale, y / scale, t), then three octaves
  v + gain noise(x / scale 2, ...), v + gain gain noise(x / scale 4, ...),
  v + gain gain gain noise(x / scale 8, ...), in the source's order of
  operations; gray 1/2 + 1/2 v.
- voronoi (Worley's F2 - F1 cell edges, "A Cellular Texture Basis
  Function", SIGGRAPH 1996): the pixel's cell (gx, gy) = floor((x, y) /
  cell); over the 3x3 cells around it, j outer and i inner, the feature
  point ((cx + 1/2 + 0.45 n1) cell, (cy + 1/2 + 0.45 n2) cell) with
  n1 = noise(0.7131 cx, 0.7131 cy, 1/2) and n2 = noise(0.7131 cx + 31.7,
  0.7131 cy + 17.3, 1/2); the nearest squared distance `best`, the second
  `second` and the nearest cell's id 1/2 + n1/2, updated as the source
  updates them; edge = smoothstep(0, 0.08, (sqrt(second) - sqrt(best)) /
  cell); the default gradient (black to white, opaque, 256 rows, read as
  reference/generative.py reads it) at clamp(id, 0, 1), every channel,
  alpha included, times edge, as MathMap multiplies a colour by a scalar.

Departures: the 3x3 scan is unrolled here, 18 noise calls, where the
source's two while loops run; the program's loop probe, which evaluates a
loop's condition and body once more and discards the result, has no
counterpart. A lattice coordinate that is not finite or is 2^31 or more
in magnitude is not mapped to cell 0 as the program maps it to match
NumPy's integer conversion: this traffic's noise coordinates stay under
300 in magnitude (x / scale 8 with |x| <= 1920 and scale >= 60; 0.7131
(x / cell + 1) + 31.7 with cell >= 70).
"""

from __future__ import annotations

import numpy as np
import torch

from .common import finish, gray, grids, lit

#: Perlin's reference permutation of 0..255 ("Improving Noise", 2002)
PERMUTATION = (
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
)
GRADIENT_ROWS = 256


def fade(t: torch.Tensor) -> torch.Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def lerp(t: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + t * (b - a)


def grad(h: torch.Tensor, x, y, z) -> torch.Tensor:
    """The dot product of (x, y, z) with the gradient that the low four
    bits of hash h pick."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def perlin(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Improved noise at (x, y, z), tensors of one dtype and device that
    broadcast together."""
    x, y, z = torch.broadcast_tensors(x, y, z)
    p = torch.tensor(PERMUTATION + PERMUTATION, dtype=torch.int64, device=x.device)
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    cx, cy, cz = (f.to(torch.int64) & 255 for f in (fx, fy, fz))
    x, y, z = x - fx, y - fy, z - fz
    u, v, w = fade(x), fade(y), fade(z)
    a = p[cx] + cy
    aa = p[a] + cz
    ab = p[a + 1] + cz
    b = p[cx + 1] + cy
    ba = p[b] + cz
    bb = p[b + 1] + cz
    return lerp(w, lerp(v, lerp(u, grad(p[aa], x, y, z),
                                grad(p[ba], x - 1, y, z)),
                        lerp(u, grad(p[ab], x, y - 1, z),
                             grad(p[bb], x - 1, y - 1, z))),
                lerp(v, lerp(u, grad(p[aa + 1], x, y, z - 1),
                             grad(p[ba + 1], x - 1, y, z - 1)),
                     lerp(u, grad(p[ab + 1], x, y - 1, z - 1),
                          grad(p[bb + 1], x - 1, y - 1, z - 1))))


def turbulence(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    scale = lit(params.get("scale", 80.0), dtype, device)
    gain = lit(params.get("gain", 0.5), dtype, device)
    z = lit(t, dtype, device)
    two, four, eight = (lit(k, dtype, device) for k in (2.0, 4.0, 8.0))
    v = perlin(x / scale, y / scale, z)
    v = v + gain * perlin(x / scale * two, y / scale * two, z)
    v = v + gain * gain * perlin(x / scale * four, y / scale * four, z)
    v = v + gain * gain * gain * perlin(x / scale * eight, y / scale * eight, z)
    half = lit(0.5, dtype, device)
    return finish(gray(half + half * v))


def gradient(pos: torch.Tensor) -> torch.Tensor:
    """The default gradient at `pos`: the gray level of its RGBA (alpha 1)."""
    dtype, device = pos.dtype, pos.device
    ramp = torch.from_numpy(np.linspace(0.0, 1.0, GRADIENT_ROWS, dtype=np.float32))
    ramp = ramp.to(device=device, dtype=dtype)
    pos = torch.clamp(pos, 0.0, 1.0) * lit(GRADIENT_ROWS - 1.0, dtype, device)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.to(torch.int64).clamp(0, GRADIENT_ROWS - 1)
    i1 = (i0 + 1).clamp(max=GRADIENT_ROWS - 1)
    return ramp[i0] + frac * (ramp[i1] - ramp[i0])


def voronoi(params, t, width, height, image, dtype, device):
    x, y = grids(width, height, dtype, device)
    cell = lit(params.get("cell", 90.0), dtype, device)
    gx, gy = torch.floor(x / cell), torch.floor(y / cell)
    k, half, jitter = (lit(v, dtype, device) for v in (0.7131, 0.5, 0.45))
    dx, dy, z = lit(31.7, dtype, device), lit(17.3, dtype, device), lit(0.5, dtype, device)
    one = lit(1.0, dtype, device)
    best = torch.full_like(x, 1e9)
    second = torch.full_like(x, 1e9)
    cell_id = torch.zeros_like(x)
    for j in (-1.0, 0.0, 1.0):
        for i in (-1.0, 0.0, 1.0):
            cxg = gx + lit(i, dtype, device)
            cyg = gy + lit(j, dtype, device)
            n1 = perlin(cxg * k, cyg * k, z)
            n2 = perlin(cxg * k + dx, cyg * k + dy, z)
            px = (cxg + half + jitter * n1) * cell
            py = (cyg + half + jitter * n2) * cell
            d = (x - px) * (x - px) + (y - py) * (y - py)
            closer = (d < best).to(dtype)
            second = torch.minimum(second, best * closer + d * (one - closer))
            cell_id = (n1 * half + half) * closer + cell_id * (one - closer)
            best = torch.minimum(best, d)
    s = torch.clamp((torch.sqrt(second) - torch.sqrt(best)) / cell / lit(0.08, dtype, device),
                    0.0, 1.0)
    edge = s * s * (lit(3.0, dtype, device) - lit(2.0, dtype, device) * s)
    g = gradient(torch.clamp(cell_id, 0.0, 1.0)) * edge
    return finish(torch.stack([g, g, g, edge], dim=-1))
