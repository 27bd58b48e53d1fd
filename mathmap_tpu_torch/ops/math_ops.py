"""Arithmetic, comparison, logical, trig/exp and misc scalar builtins on
torch tensors (the port of `mathmap_tpu/ops/math_ops.py`).

Operator tokens are routed here as builtins named `__add`, `__mul`, ...;
`__mul` dispatches complex (`ri:`) operands to complex_ops and matrix
(`m2x2:`/`m3x3:`), quaternion (`quat:`/`cquat:`) and hypercomplex
(`hyper:`) operands to vector_ops, in the reference's order
(`_special_pair_kind`); `__div` dispatches a complex denominator.
"""

from __future__ import annotations

import math

import torch

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from . import libm
from .registry import (
    broadcast_pair,
    builtin,
    ew1,
    ew2,
    need_args,
    result_tag,
)
from .vector_ops import matrix_mul, quat_mul

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _to_float(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.float32)


def _truthy(v: TupleValue, span) -> torch.Tensor:
    """MathMap condition: a length-1 tuple, true iff != 0."""
    if v.is_opaque or v.length != 1:
        raise MMTypeError("condition must be a single value", span)
    return v.arrays[0] != 0


# ---------------------------------------------------------------------------
# arithmetic operators
# ---------------------------------------------------------------------------

ew2("__add", torch.add)
ew2("__sub", torch.sub)
# `%` is floored mod (sign of the divisor), like np.mod: torch.remainder,
# never torch.fmod
ew2("__mod", torch.remainder)


@builtin("__mul")
def _mul(ev, args, span):
    a, b = need_args(args, 2, "*", span)
    if a.tag == "ri" and b.tag == "ri":
        from .complex_ops import c_mul

        return c_mul(a, b)
    if a.tag == b.tag and a.tag in ("quat", "cquat", "hyper"):
        return quat_mul(a, b, a.tag)
    if a.tag in ("m2x2", "m3x3") or b.tag in ("m2x2", "m3x3"):
        return matrix_mul(ev, a, b, span)
    pairs = broadcast_pair(a, b, span, "*")
    return TupleValue(result_tag(a, b), tuple(x * y for x, y in pairs))


@builtin("__div")
def _div(ev, args, span):
    a, b = need_args(args, 2, "/", span)
    if b.tag == "ri":
        # complex division whenever the DENOMINATOR is complex; a scalar
        # numerator promotes (1/z is the complex reciprocal)
        from .complex_ops import c_div

        if a.tag == "ri":
            return c_div(a, b)
        s = a.scalar(span)
        return c_div(TupleValue("ri", (s, torch.zeros_like(s))), b)
    pairs = broadcast_pair(a, b, span, "/")
    return TupleValue(result_tag(a, b), tuple(x / y for x, y in pairs))


@builtin("__neg")
def _neg(ev, args, span):
    (a,) = need_args(args, 1, "unary -", span)
    if a.is_opaque:
        raise MMTypeError(f"unary '-' not defined on {a.tag}", span)
    return TupleValue(a.tag, tuple(-x for x in a.arrays))


# ---------------------------------------------------------------------------
# comparisons (0/1 result) and logic
# ---------------------------------------------------------------------------

def _cmp(name, fn, any_comp=False):
    @builtin(name)
    def _op(ev, args, span, _fn=fn, _name=name, _any=any_comp):
        a, b = need_args(args, 2, _name, span)
        pairs = broadcast_pair(a, b, span, _name)
        # tuples compare componentwise-AND, except '!=', the negation of
        # '==': true when ANY component differs
        acc = _fn(*pairs[0])
        for x, y in pairs[1:]:
            acc = (acc | _fn(x, y)) if _any else (acc & _fn(x, y))
        return TupleValue(NIL, (_to_float(acc),))


_cmp("__eq", torch.eq)
_cmp("__ne", torch.ne, any_comp=True)
_cmp("__lt", torch.lt)
_cmp("__gt", torch.gt)
_cmp("__le", torch.le)
_cmp("__ge", torch.ge)


@builtin("__and")
def _and(ev, args, span):
    a, b = need_args(args, 2, "&&", span)
    return TupleValue(NIL, (_to_float(_truthy(a, span) & _truthy(b, span)),))


@builtin("__or")
def _or(ev, args, span):
    a, b = need_args(args, 2, "||", span)
    return TupleValue(NIL, (_to_float(_truthy(a, span) | _truthy(b, span)),))


@builtin("__xor")
def _xor(ev, args, span):
    a, b = need_args(args, 2, "xor", span)
    return TupleValue(NIL, (_to_float(_truthy(a, span) ^ _truthy(b, span)),))


@builtin("__not")
def _not(ev, args, span):
    (a,) = need_args(args, 1, "!", span)
    return TupleValue(NIL, (_to_float(~_truthy(a, span)),))


# ---------------------------------------------------------------------------
# trig / exp / log (exp, sqrt, sin, cos and tan get their complex
# overloads in complex_ops)
# ---------------------------------------------------------------------------

ew1("asin", libm.asin)
ew1("acos", libm.acos)
ew1("sinh", libm.sinh)
ew1("cosh", libm.cosh)
ew1("tanh", libm.tanh)
ew1("asinh", libm.asinh)
ew1("acosh", libm.acosh)
ew1("atanh", libm.atanh)
ew1("floor", torch.floor)
ew1("ceil", torch.ceil)
ew1("round", torch.round)  # half to even, like np.round
ew1("sign", torch.sign)
ew1("deg2rad", lambda x: x * (math.pi / 180.0))
ew1("rad2deg", lambda x: x * (180.0 / math.pi))


@builtin("log")
def _log(ev, args, span):
    (a,) = need_args(args, 1, "log", span)
    if a.is_opaque:
        raise MMTypeError(f"'log' not defined on {a.tag}", span)
    if a.tag == "ri":
        from .complex_ops import c_log

        return c_log(a)
    return TupleValue(a.tag, tuple(torch.log(x) for x in a.arrays))


@builtin("atan")
def _atan(ev, args, span):
    if len(args) == 1:
        (a,) = args
        if a.is_opaque:
            raise MMTypeError(f"'atan' not defined on {a.tag}", span)
        return TupleValue(a.tag, tuple(libm.atan(x) for x in a.arrays))
    a, b = need_args(args, 2, "atan", span)
    pairs = broadcast_pair(a, b, span, "atan")
    return TupleValue(result_tag(a, b), tuple(libm.atan2(x, y) for x, y in pairs))


ew2("atan2", libm.atan2)
# `__pow` and `pow` (with the complex overload) live in ops/__init__


# ---------------------------------------------------------------------------
# min/max/clamp/lerp/misc
# ---------------------------------------------------------------------------

ew2("min", torch.minimum)
ew2("max", torch.maximum)


@builtin("clamp")
def _clamp(ev, args, span):
    a, lo, hi = need_args(args, 3, "clamp", span)
    lo_p = broadcast_pair(a, lo, span, "clamp")
    hi_p = broadcast_pair(a, hi, span, "clamp")
    if len(lo_p) != len(hi_p):
        # e.g. clamp(scalar, rgba, 1): broadcast the shorter side
        if len(lo_p) == 1:
            lo_p = lo_p * len(hi_p)
        elif len(hi_p) == 1:
            hi_p = hi_p * len(lo_p)
        else:
            raise MMTypeError(
                f"clamp: lo/hi lengths {len(lo_p)} vs {len(hi_p)} "
                f"don't broadcast", span)
    out = tuple(
        torch.minimum(torch.maximum(x, l), h)
        for (x, l), (_, h) in zip(lo_p, hi_p)
    )
    tag = a.tag if len(out) == len(a.arrays) else NIL
    return TupleValue(tag, out)


@builtin("lerp")
def _lerp(ev, args, span):
    # lerp(t, a, b) = a + t*(b-a)
    t, a, b = need_args(args, 3, "lerp", span)
    tt = t.scalar(span)
    pairs = broadcast_pair(a, b, span, "lerp")
    return TupleValue(result_tag(a, b), tuple(x + tt * (y - x) for x, y in pairs))


@builtin("scale")
def _scale(ev, args, span):
    # scale(v, from_lo, from_hi, to_lo, to_hi) — affine remap; also
    # scale(v, s) = v * s
    if len(args) == 2:
        v, s = args
        ss = s.scalar(span)
        return TupleValue(v.tag, tuple(x * ss for x in v.arrays))
    v, a0, a1, b0, b1 = need_args(args, 5, "scale", span)
    a0s, a1s, b0s, b1s = (w.scalar(span) for w in (a0, a1, b0, b1))
    return TupleValue(
        v.tag, tuple(b0s + (x - a0s) * (b1s - b0s) / (a1s - a0s) for x in v.arrays)
    )


@builtin("inintv")
def _inintv(ev, args, span):
    x, lo, hi = need_args(args, 3, "inintv", span)
    xs, los, his = x.scalar(span), lo.scalar(span), hi.scalar(span)
    return TupleValue(NIL, (_to_float((xs >= los) & (xs <= his)),))


@builtin("abs")
def _abs(ev, args, span):
    (a,) = need_args(args, 1, "abs", span)
    if a.is_opaque:
        raise MMTypeError("'abs' not defined on opaque values", span)
    # norm for geometric/complex tags, elementwise otherwise
    if a.tag in ("ri", "v2", "v3", "quat", "cquat", "hyper", "xy"):
        acc = a.arrays[0] * a.arrays[0]
        for x in a.arrays[1:]:
            acc = acc + x * x
        return TupleValue(NIL, (libm.sqrt(acc),))
    return TupleValue(a.tag, tuple(torch.abs(x) for x in a.arrays))


# -- additional scalar utilities (log bases, C-style fmod, hypot, smoothstep)
ew1("log2", torch.log2)
ew1("log10", torch.log10)
ew1("exp2", torch.exp2)
# C fmod: the sign follows the dividend (unlike '%', which is floored mod)
ew2("fmod", torch.fmod)
ew2("hypot", lambda x, y: libm.sqrt(x * x + y * y))


@builtin("smoothstep")
def _smoothstep(ev, args, span):
    lo, hi, x = need_args(args, 3, "smoothstep", span)
    los, his, xs = lo.scalar(span), hi.scalar(span), x.scalar(span)
    t = torch.clamp((xs - los) / (his - los), 0.0, 1.0)
    return TupleValue(NIL, (t * t * (3.0 - 2.0 * t),))


@builtin("rand")
def _rand(ev, args, span):
    """rand(lo, hi): one draw per pixel (Evaluator.rand_uniform), scaled."""
    lo, hi = need_args(args, 2, "rand", span)
    los, his = lo.scalar(span), hi.scalar(span)
    u = ev.rand_uniform()
    return TupleValue(NIL, (los + u * (his - los),))
