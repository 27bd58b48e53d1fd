"""Complex-number builtins on `ri:` tuples (the port of
`mathmap_tpu/ops/complex_ops.py`).

Complex values are ri:[re, im] kept in split real/imaginary form, so every
step stays an elementwise float32 tensor op, as in the reference.
"""

from __future__ import annotations

import torch

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from . import libm
from .registry import builtin, need_args, need_length


def c_mul(a: TupleValue, b: TupleValue) -> TupleValue:
    ar, ai = a.arrays
    br, bi = b.arrays
    return TupleValue("ri", (ar * br - ai * bi, ar * bi + ai * br))


def c_div(a: TupleValue, b: TupleValue) -> TupleValue:
    ar, ai = a.arrays
    br, bi = b.arrays
    d = br * br + bi * bi
    return TupleValue("ri", ((ar * br + ai * bi) / d, (ai * br - ar * bi) / d))


def c_exp(a: TupleValue) -> TupleValue:
    re, im = a.arrays
    m = torch.exp(re)
    return TupleValue("ri", (m * libm.cos(im), m * libm.sin(im)))


def c_log(a: TupleValue) -> TupleValue:
    re, im = a.arrays
    return TupleValue("ri", (0.5 * torch.log(re * re + im * im), libm.atan2(im, re)))


def c_sqrt(a: TupleValue) -> TupleValue:
    re, im = a.arrays
    r = libm.sqrt(libm.sqrt(re * re + im * im))
    th = 0.5 * libm.atan2(im, re)
    return TupleValue("ri", (r * libm.cos(th), r * libm.sin(th)))


def c_sin(a: TupleValue) -> TupleValue:
    re, im = a.arrays
    return TupleValue("ri", (libm.sin(re) * libm.cosh(im), libm.cos(re) * libm.sinh(im)))


def c_cos(a: TupleValue) -> TupleValue:
    re, im = a.arrays
    return TupleValue("ri", (libm.cos(re) * libm.cosh(im), -libm.sin(re) * libm.sinh(im)))


def c_tan(a: TupleValue) -> TupleValue:
    return c_div(c_sin(a), c_cos(a))


def c_pow(a: TupleValue, b: TupleValue) -> TupleValue:
    # z^w = exp(w * log z)
    return c_exp(c_mul(b, c_log(a)))


@builtin("conj")
def _conj(ev, args, span):
    (a,) = need_args(args, 1, "conj", span)
    need_length(a, 2, "conj", span)
    return TupleValue(a.tag, (a.arrays[0], -a.arrays[1]))


@builtin("arg")
def _arg(ev, args, span):
    (a,) = need_args(args, 1, "arg", span)
    need_length(a, 2, "arg", span)
    return TupleValue(NIL, (libm.atan2(a.arrays[1], a.arrays[0]),))


# -- overload-aware trig/exp builtins: ri: goes to the complex form, any
# other tag elementwise

def _complex_dispatch(name: str, complex_fn, real_fn):
    @builtin(name)
    def _op(ev, args, span, _cfn=complex_fn, _rfn=real_fn, _name=name):
        (a,) = need_args(args, 1, _name, span)
        if a.is_opaque:
            raise MMTypeError(f"{_name!r} not defined on {a.tag}", span)
        if a.tag == "ri":
            return _cfn(a)
        return TupleValue(a.tag, tuple(_rfn(x) for x in a.arrays))


_complex_dispatch("exp", c_exp, torch.exp)
_complex_dispatch("sqrt", c_sqrt, libm.sqrt)
_complex_dispatch("sin", c_sin, libm.sin)
_complex_dispatch("cos", c_cos, libm.cos)
_complex_dispatch("tan", c_tan, libm.tan)
