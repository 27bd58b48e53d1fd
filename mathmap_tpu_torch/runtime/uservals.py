"""User values (filter parameters): defaults and Python-value conversion
(the port of `mathmap_tpu/runtime/uservals.py`) for float, int, bool,
color, curve, gradient and image params. Positional input images are bound
by render.build_env; an image param may also be bound by value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lang.astnodes import Param
from ..typesys.tags import NIL
from ..utils.errors import MMRuntimeError, MMTypeError
from ..utils.trace import span
from .value import (Curve, Gradient, InputImage, TupleValue, curve_value, gradient_value,
                    image_value, to_device)

_PARAM = span("mm.sync.param")


def _tuple(ctx, tag: str, values, const=None) -> TupleValue:
    """Numeric, bool and color values are float32 0-d tensors in every
    render, the float64 spec's included, as in the reference. Each is a
    copy from the host, which on a card waits for the device's queue."""
    arrays = tuple(_PARAM.tensor(float(v), torch.float32, ctx.device) for v in values)
    return TupleValue(tag, arrays, const=const)


def default_userval(ctx, p: Param) -> TupleValue:
    # numeric defaults carry a host-side const mirror, as in the reference
    if p.kind in ("int", "float"):
        v = p.default
        if v is None:
            v = p.lo if p.lo is not None else 0.0
        return _tuple(ctx, NIL, (v,), const=(float(v),))
    if p.kind == "bool":
        v = p.default if p.default is not None else 0.0
        v = 1.0 if v else 0.0
        return _tuple(ctx, NIL, (v,), const=(v,))
    if p.kind == "color":
        # default opaque black
        return _tuple(ctx, "rgba", (0.0, 0.0, 0.0, 1.0),
                      const=(0.0, 0.0, 0.0, 1.0))
    if p.kind == "curve":
        return curve_value(Curve.identity(ctx.device))
    if p.kind == "gradient":
        return gradient_value(Gradient.default(ctx.device))
    if p.kind == "image":
        raise MMRuntimeError(
            f"image parameter {p.name!r} has no bound input image", p.span
        )
    raise MMTypeError(f"unknown userval kind {p.kind!r}", p.span)


def convert_userval(ctx, p: Param, value) -> TupleValue:
    """Convert a Python value supplied through the API into the userval's
    runtime representation. A name in opts.static_params also carries its
    value as a host-side constant (the reference bakes it)."""
    if p.kind in ("int", "float"):
        v = float(value)
        if p.kind == "int":
            v = float(int(round(v)))
        if p.lo is not None:
            v = max(v, p.lo)
        if p.hi is not None:
            v = min(v, p.hi)
        vals, tag = (v,), NIL
    elif p.kind == "bool":
        vals, tag = (1.0 if value else 0.0,), NIL
    elif p.kind == "color":
        vals = tuple(float(c) for c in value)
        if len(vals) == 3:
            vals = vals + (1.0,)
        if len(vals) != 4:
            raise MMTypeError(f"color userval {p.name!r} needs 3 or 4 components", p.span)
        tag = "rgba"
    elif p.kind == "curve":
        return curve_value(_curve(ctx, p, value))
    elif p.kind == "gradient":
        return gradient_value(_gradient(ctx, p, value))
    elif p.kind == "image":
        return image_value(_image(ctx, p, value))
    else:
        raise MMTypeError(f"unknown userval kind {p.kind!r}", p.span)
    static = p.name in ctx.opts.static_params
    return _tuple(ctx, tag, vals, const=tuple(float(v) for v in vals) if static else None)


def _lut_array(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _curve(ctx, p: Param, value) -> Curve:
    """A Curve, a callable on the (K,) position ramp, or a 1-D LUT of at
    least 2 samples -> a Curve on the render device."""
    if isinstance(value, Curve):
        return Curve(lut=to_device(value.lut.to(torch.float32), ctx.device), name=value.name)
    if callable(value):
        return Curve.from_function(ctx.device, value)
    lut = _lut_array(value)
    if lut.dim() != 1 or lut.shape[0] < 2:
        raise MMTypeError(
            f"curve userval {p.name!r} needs a 1-D LUT of >=2 samples "
            f"(or a Curve / callable)", p.span)
    return Curve(lut=to_device(lut, ctx.device).contiguous())


def _gradient(ctx, p: Param, value) -> Gradient:
    """A Gradient or an (N, 3) / (N, 4) array (RGB gets an opaque alpha)
    -> a Gradient on the render device."""
    if isinstance(value, Gradient):
        return Gradient(lut=to_device(value.lut.to(torch.float32), ctx.device),
                        name=value.name)
    lut = _lut_array(value)
    if lut.dim() != 2 or lut.shape[1] not in (3, 4):
        raise MMTypeError(
            f"gradient userval {p.name!r} needs an (N,3) or (N,4) array", p.span)
    if lut.shape[1] == 3:
        lut = torch.cat([lut, torch.ones((lut.shape[0], 1), dtype=torch.float32)], dim=1)
    return Gradient(lut=to_device(lut, ctx.device).contiguous())


def _image(ctx, p: Param, value) -> InputImage:
    """An InputImage, or an (H, W, 4) or animated (T, H, W, 4) array or
    tensor -> an InputImage on the render device. A uint8 image stays
    uint8: the sampler converts each tap by /255, the reference's rule for
    a u8 image param, so it never feeds 0-255 values to the filter; any
    other dtype becomes float32."""
    if isinstance(value, InputImage):
        return InputImage(pixels=to_device(value.pixels, ctx.device), name=value.name)
    pix = value.detach() if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(value))
    if pix.dtype != torch.uint8:
        pix = pix.to(torch.float32)
    if pix.dim() not in (3, 4) or pix.shape[-1] != 4:
        raise MMTypeError(
            f"image userval {p.name!r} needs an (H,W,4) or animated "
            f"(T,H,W,4) array", p.span)
    return InputImage(pixels=to_device(pix, ctx.device).contiguous(), name=p.name)
