"""Vector, matrix, quaternion and hypercomplex builtins on torch tensors
(the port of `mathmap_tpu/ops/vector_ops.py`).

Matrices are row-major flat tuples: m2x2:[a,b,c,d] = [[a,b],[c,d]]; m3x3
has 9 components. Every component is a whole-grid tensor (or a 0-d one),
so a per-pixel matrix product is a handful of elementwise multiplies and
adds. Each builtin is written only as per-component `+ - * /`,
`torch.sqrt` and `torch.where` with the evaluator's literals, the ops kernel
B3's loop tracer (kernels/while_loop.Sym) records, so a loop body that calls
`length`, `dotp`, `crossp` or `normalize`, or multiplies quaternions, can
run as a generated kernel.
"""

from __future__ import annotations

import torch

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from . import libm
from .registry import builtin, need_args, need_length


def _sum_of_squares(v: TupleValue):
    acc = v.arrays[0] * v.arrays[0]
    for x in v.arrays[1:]:
        acc = acc + x * x
    return acc


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------

@builtin("dotp")
def _dotp(ev, args, span):
    a, b = need_args(args, 2, "dotp", span)
    if a.is_opaque or b.is_opaque or a.length != b.length:
        raise MMTypeError("'dotp' expects two tuples of equal length", span)
    acc = a.arrays[0] * b.arrays[0]
    for x, y in zip(a.arrays[1:], b.arrays[1:]):
        acc = acc + x * y
    return TupleValue(NIL, (acc,))


@builtin("crossp")
def _crossp(ev, args, span):
    a, b = need_args(args, 2, "crossp", span)
    need_length(a, 3, "crossp", span)
    need_length(b, 3, "crossp", span)
    a1, a2, a3 = a.arrays
    b1, b2, b3 = b.arrays
    return TupleValue("v3", (a2 * b3 - a3 * b2, a3 * b1 - a1 * b3, a1 * b2 - a2 * b1))


@builtin("normalize")
def _normalize(ev, args, span):
    (v,) = need_args(args, 1, "normalize", span)
    if v.is_opaque:
        raise MMTypeError("'normalize' expects a numeric tuple", span)
    norm = libm.sqrt(_sum_of_squares(v))
    safe = torch.where(norm == 0, ev.lit(1.0), norm)
    return TupleValue(v.tag, tuple(x / safe for x in v.arrays))


@builtin("length")
def _length(ev, args, span):
    (v,) = need_args(args, 1, "length", span)
    if v.is_opaque:
        raise MMTypeError("'length' expects a numeric tuple", span)
    return TupleValue(NIL, (libm.sqrt(_sum_of_squares(v)),))


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------

def matrix_mul(ev, a: TupleValue, b: TupleValue, span) -> TupleValue:
    """m2x2/m3x3 multiplication: matrix times matrix, matrix times vector,
    scalar times matrix (either side)."""
    if a.is_opaque or b.is_opaque:
        raise MMTypeError(f"'*' not defined for {a.tag} and {b.tag}", span)
    if a.tag == "m2x2" and b.tag == "m2x2":
        a11, a12, a21, a22 = a.arrays
        b11, b12, b21, b22 = b.arrays
        return TupleValue("m2x2", (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
                                   a21 * b11 + a22 * b21, a21 * b12 + a22 * b22))
    if a.tag == "m2x2" and b.length == 2:
        a11, a12, a21, a22 = a.arrays
        x, y = b.arrays
        return TupleValue(b.tag if b.tag != NIL else "v2",
                          (a11 * x + a12 * y, a21 * x + a22 * y))
    if a.tag == "m3x3" and b.tag == "m3x3":
        out = []
        for i in range(3):
            for j in range(3):
                acc = a.arrays[3 * i] * b.arrays[j]
                for k in range(1, 3):
                    acc = acc + a.arrays[3 * i + k] * b.arrays[3 * k + j]
                out.append(acc)
        return TupleValue("m3x3", tuple(out))
    if a.tag == "m3x3" and b.length == 3:
        out = []
        for i in range(3):
            acc = a.arrays[3 * i] * b.arrays[0]
            for k in range(1, 3):
                acc = acc + a.arrays[3 * i + k] * b.arrays[k]
            out.append(acc)
        return TupleValue(b.tag if b.tag != NIL else "v3", tuple(out))
    if b.tag in ("m2x2", "m3x3") and a.length == 1:
        s = a.arrays[0]
        return TupleValue(b.tag, tuple(s * x for x in b.arrays))
    if a.tag in ("m2x2", "m3x3") and b.length == 1:
        s = b.arrays[0]
        return TupleValue(a.tag, tuple(s * x for x in a.arrays))
    raise MMTypeError(f"'*' not defined for {a.tag}:{a.length} and {b.tag}:{b.length}", span)


@builtin("det")
def _det(ev, args, span):
    (m,) = need_args(args, 1, "det", span)
    if m.tag == "m2x2":
        a, b, c, d = m.arrays
        return TupleValue(NIL, (a * d - b * c,))
    if m.tag == "m3x3":
        a, b, c, d, e, f, g, h, i = m.arrays
        return TupleValue(NIL, (a * (e * i - f * h) - b * (d * i - f * g)
                                + c * (d * h - e * g),))
    raise MMTypeError("'det' expects m2x2: or m3x3:", span)


@builtin("solve")
def _solve(ev, args, span):
    """solve(M, v): M x = v by Cramer's rule. A singular matrix (det == 0)
    gives inf/NaN components by IEEE division, as in the reference."""
    m, v = need_args(args, 2, "solve", span)
    if m.tag == "m2x2":
        need_length(v, 2, "solve", span)
        a, b, c, d = m.arrays
        x0, x1 = v.arrays
        det = a * d - b * c
        return TupleValue("v2", ((x0 * d - b * x1) / det, (a * x1 - x0 * c) / det))
    if m.tag == "m3x3":
        need_length(v, 3, "solve", span)
        a, b, c, d, e, f, g, h, i = m.arrays
        r0, r1, r2 = v.arrays
        det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
        dx = r0 * (e * i - f * h) - b * (r1 * i - f * r2) + c * (r1 * h - e * r2)
        dy = a * (r1 * i - f * r2) - r0 * (d * i - f * g) + c * (d * r2 - r1 * g)
        dz = a * (e * r2 - r1 * h) - b * (d * r2 - r1 * g) + r0 * (d * h - e * g)
        return TupleValue("v3", (dx / det, dy / det, dz / det))
    raise MMTypeError("'solve' expects m2x2: or m3x3:", span)


# ---------------------------------------------------------------------------
# quaternions / hypercomplex
# ---------------------------------------------------------------------------

def quat_mul(a: TupleValue, b: TupleValue, kind: str) -> TupleValue:
    """quat: the Hamilton product; cquat: and hyper: the commutative
    hypercomplex product (the Fractint convention)."""
    a1, a2, a3, a4 = a.arrays
    b1, b2, b3, b4 = b.arrays
    if kind == "quat":
        return TupleValue("quat", (
            a1 * b1 - a2 * b2 - a3 * b3 - a4 * b4,
            a1 * b2 + a2 * b1 + a3 * b4 - a4 * b3,
            a1 * b3 - a2 * b4 + a3 * b1 + a4 * b2,
            a1 * b4 + a2 * b3 - a3 * b2 + a4 * b1,
        ))
    return TupleValue(a.tag, (
        a1 * b1 - a2 * b2 - a3 * b3 + a4 * b4,
        a1 * b2 + a2 * b1 - a3 * b4 - a4 * b3,
        a1 * b3 + a3 * b1 - a2 * b4 - a4 * b2,
        a1 * b4 + a4 * b1 + a2 * b3 + a3 * b2,
    ))
