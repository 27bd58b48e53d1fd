"""User values (filter parameters): defaults and Python-value conversion
(the port of `mathmap_tpu/runtime/uservals.py`) for float, int, bool and
color params. Curve and gradient params come with kernel B2 (ROADMAP A6);
image params bound by value come with the rest of the renderer
(ROADMAP A4) — positional input images are bound by render.build_env.
"""

from __future__ import annotations

import torch

from ..lang.astnodes import Param
from ..ops.registry import not_ported
from ..typesys.tags import NIL
from ..utils.errors import MMRuntimeError, MMTypeError
from .value import TupleValue

_NOT_PORTED_KINDS = {"curve": "ROADMAP A6", "gradient": "ROADMAP A6",
                     "image": "ROADMAP A4"}


def _tuple(ctx, tag: str, values, const=None) -> TupleValue:
    return TupleValue(tag, tuple(torch.tensor(float(v), dtype=ctx.dtype,
                                              device=ctx.device)
                                 for v in values), const=const)


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
    if p.kind == "image":
        raise MMRuntimeError(
            f"image parameter {p.name!r} has no bound input image", p.span
        )
    if p.kind in _NOT_PORTED_KINDS:
        raise not_ported(f"{p.kind} parameters", _NOT_PORTED_KINDS[p.kind])
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
    elif p.kind in _NOT_PORTED_KINDS:
        raise not_ported(f"{p.kind} parameters", _NOT_PORTED_KINDS[p.kind])
    else:
        raise MMTypeError(f"unknown userval kind {p.kind!r}", p.span)
    static = p.name in ctx.opts.static_params
    return _tuple(ctx, tag, vals, const=tuple(float(v) for v in vals) if static else None)
