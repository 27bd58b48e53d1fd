"""Perlin noise: `perlin3` and the `noise` builtin (the port of the NumPy
branch of `mathmap_tpu/ops/noise.py`).

Ken Perlin's improved noise (2002) over his reference permutation table,
doubled to 512 entries. Each table lookup P(i) is a direct gather from an
int32 copy of the table on the render device, made once per device for
live renders and afresh inside a trace (torch.export), where it becomes a
constant of the program; the reference's TPU one-hot contraction is not
ported. Every op is eager torch: on the card noise has no kernel of its
own.
"""

from __future__ import annotations

import functools

import torch

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from ..utils.trace import span
from .registry import builtin

#: Ken Perlin's reference permutation (256 entries), the reference's _PERM
PERM = (
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


def perm_table(device) -> torch.Tensor:
    """The doubled 512-entry table as int32 on `device`, made once per
    device. Under torch.export or torch.compile a tensor made here is the
    tracer's, not a real one: it is made afresh for the program and never
    kept, so a later live render or export gets a real table."""
    if torch.compiler.is_compiling():
        return torch.tensor(PERM + PERM, dtype=torch.int32, device=device)
    return _table(torch.device(device))


@functools.cache
def _table(device: torch.device) -> torch.Tensor:
    with span("mm.sync.literal"):
        return torch.tensor(PERM + PERM, dtype=torch.int32, device=device)


def lattice(f: torch.Tensor) -> torch.Tensor:
    """A floored coordinate's lattice index: the reference's
    `astype(int32) & 255` as NumPy computes it on x86, on every device. There
    a NaN, an infinity or a value outside int32 converts to INT_MIN, whose
    low byte is 0; CUDA's conversion saturates instead (+inf and finite
    values from 2^31 up give INT_MAX, low byte 255; NaN gives 0), so those
    are mapped to 0 before converting. A NaN or infinite coordinate makes
    the noise NaN whatever its index, but at a finite one from 2^31 up the
    fraction is 0 and the noise is the gradient at the lattice point, which
    the index picks: without the mapping the card would give another value
    there."""
    return torch.where(f.abs() < 2147483648.0, f, 0.0).to(torch.int32) & 255


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Gradient dot-product for hash h (improved-noise 12-gradient set)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def perlin3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Improved Perlin noise at (x, y, z): float32 tensors of one device
    that broadcast together, in the reference's order of operations."""
    xf, yf, zf = torch.floor(x), torch.floor(y), torch.floor(z)
    xi, yi, zi = lattice(xf), lattice(yf), lattice(zf)
    x, y, z = x - xf, y - yf, z - zf
    u, v, w = _fade(x), _fade(y), _fade(z)
    table = perm_table(x.device)

    def P(i):
        return table[i]

    a = P(xi) + yi
    aa = P(a) + zi
    ab = P(a + 1) + zi
    b = P(xi + 1) + yi
    ba = P(b) + zi
    bb = P(b + 1) + zi

    def lerp(t, p0, p1):
        return p0 + t * (p1 - p0)

    n000 = _grad(P(aa), x, y, z)
    n100 = _grad(P(ba), x - 1.0, y, z)
    n010 = _grad(P(ab), x, y - 1.0, z)
    n110 = _grad(P(bb), x - 1.0, y - 1.0, z)
    n001 = _grad(P(aa + 1), x, y, z - 1.0)
    n101 = _grad(P(ba + 1), x - 1.0, y, z - 1.0)
    n011 = _grad(P(ab + 1), x, y - 1.0, z - 1.0)
    n111 = _grad(P(bb + 1), x - 1.0, y - 1.0, z - 1.0)

    return lerp(
        w,
        lerp(v, lerp(u, n000, n100), lerp(u, n010, n110)),
        lerp(v, lerp(u, n001, n101), lerp(u, n011, n111)),
    )


@builtin("noise")
def _noise(ev, args, span):
    if len(args) == 1:
        (v,) = args
        if v.is_opaque or v.length != 3:
            raise MMTypeError("'noise' expects a v3:/length-3 tuple or 3 scalars", span)
        x, y, z = v.arrays
    elif len(args) == 3:
        x, y, z = (a.scalar(span) for a in args)
    else:
        raise MMTypeError("'noise' expects 1 tuple or 3 scalar arguments", span)
    return TupleValue(NIL, (perlin3(x, y, z),))
