"""Color constructors/extractors, HSVA conversion and the polar coordinate
converts, and curve and gradient application on torch tensors (the port of
`mathmap_tpu/ops/color_ops.py`). Curves and gradients go through the LUT
kernel B2's wrapper (kernels/apply_lut.py): the kernel on a CUDA tensor, its
plain version (the reference's `_lut_take`) on a CPU tensor.
"""

from __future__ import annotations

import math

import torch

from ..kernels.apply_lut import apply_lut
from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from . import libm
from .registry import builtin, need_args, need_length

LUMA_R, LUMA_G, LUMA_B = 0.299, 0.587, 0.114
_2PI = 2.0 * math.pi


@builtin("rgbColor")
def _rgb_color(ev, args, span):
    r, g, b = need_args(args, 3, "rgbColor", span)
    rs, gs, bs = r.scalar(span), g.scalar(span), b.scalar(span)
    # alpha matches the WIDEST component's shape (mixed scalar/grid args)
    a = torch.ones_like(torch.broadcast_tensors(rs, gs, bs)[0])
    return TupleValue("rgba", (rs, gs, bs, a))


@builtin("rgbaColor")
def _rgba_color(ev, args, span):
    r, g, b, a = need_args(args, 4, "rgbaColor", span)
    return TupleValue("rgba", (r.scalar(span), g.scalar(span), b.scalar(span), a.scalar(span)))


@builtin("grayColor")
def _gray_color(ev, args, span):
    (g,) = need_args(args, 1, "grayColor", span)
    gs = g.scalar(span)
    return TupleValue("rgba", (gs, gs, gs, torch.ones_like(gs)))


@builtin("grayaColor")
def _graya_color(ev, args, span):
    g, a = need_args(args, 2, "grayaColor", span)
    gs = g.scalar(span)
    return TupleValue("rgba", (gs, gs, gs, a.scalar(span)))


def _extract(name: str, idx: int):
    @builtin(name)
    def _op(ev, args, span, _idx=idx, _name=name):
        (c,) = need_args(args, 1, _name, span)
        need_length(c, 4, _name, span)
        return TupleValue(NIL, (c.arrays[_idx],))


_extract("red", 0)
_extract("green", 1)
_extract("blue", 2)
_extract("alpha", 3)


@builtin("gray")
def _gray(ev, args, span):
    (c,) = need_args(args, 1, "gray", span)
    need_length(c, 4, "gray", span)
    r, g, b, _ = c.arrays
    return TupleValue(NIL, (LUMA_R * r + LUMA_G * g + LUMA_B * b,))


@builtin("toHSVA")
def _to_hsva(ev, args, span):
    (c,) = need_args(args, 1, "toHSVA", span)
    need_length(c, 4, "toHSVA", span)
    r, g, b, a = c.arrays
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    safe_max = torch.where(maxc == 0, 1.0, maxc)
    s = torch.where(maxc == 0, 0.0, d / safe_max)
    safe_d = torch.where(d == 0, 1.0, d)
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = torch.where(
        r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(d == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    # mod of a tiny negative returns EXACTLY the modulus in float: wrap
    # back into [0, 1)
    h = torch.where(h >= 1.0, 0.0, h)
    return TupleValue("hsva", (h, s, v, a))


@builtin("toRGBA")
def _to_rgba(ev, args, span):
    (c,) = need_args(args, 1, "toRGBA", span)
    need_length(c, 4, "toRGBA", span)
    h, s, v, a = c.arrays
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i, 6.0)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return TupleValue("rgba", (pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                               pick(p, p, t, v, v, q), a))


# ---------------------------------------------------------------------------
# coordinate conversions
# ---------------------------------------------------------------------------

@builtin("toRA")
def _to_ra(ev, args, span):
    (p,) = need_args(args, 1, "toRA", span)
    need_length(p, 2, "toRA", span)
    x, y = p.arrays
    r = libm.sqrt(x * x + y * y)
    # angle in [0, 2*pi), counterclockwise from the +x axis
    a = torch.remainder(libm.atan2(y, x), _2PI)
    # float mod of a tiny negative yields EXACTLY 2*pi: wrap into [0, 2*pi)
    a = torch.where(a >= _2PI, 0.0, a)
    return TupleValue("ra", (r, a))


@builtin("toXY")
def _to_xy(ev, args, span):
    (p,) = need_args(args, 1, "toXY", span)
    need_length(p, 2, "toXY", span)
    r, a = p.arrays
    return TupleValue("xy", (r * libm.cos(a), r * libm.sin(a)))


# ---------------------------------------------------------------------------
# curve / gradient application (kernel B2)
# ---------------------------------------------------------------------------

def _lut_channels(ev, lut, x):
    """LUT application -> one tensor per LUT channel. On the card the
    position is always a contiguous full grid (a 0-d position broadcasts),
    so every application launches the kernel; on the CPU the plain version
    takes the position as it is, like the reference's oracle."""
    if x.device.type != "cpu":
        x = ev.grid(x).contiguous()
    return list(apply_lut(lut, x))


def apply_curve(ev, curve, pos: TupleValue, span) -> TupleValue:
    return TupleValue(NIL, (_lut_channels(ev, curve.lut, pos.scalar(span))[0],))


def apply_gradient(ev, grad, pos: TupleValue, span) -> TupleValue:
    return TupleValue("rgba", tuple(_lut_channels(ev, grad.lut, pos.scalar(span))))
