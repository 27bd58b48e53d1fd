"""Builtin-op registry and overload helpers (the port of
`mathmap_tpu/ops/registry.py`).

Each builtin is a Python function

    fn(ev, args: list[TupleValue], span) -> TupleValue

that does its own tag/length dispatch and computes on torch tensors. `ev`
is the evaluator: `ev.lit(v)` makes a constant on the render device in the
render dtype. The port keeps its OWN table: registering here never touches
the JAX package's table.
"""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError

#: name -> callable(ev, args, span) -> TupleValue
BUILTINS: dict = {}

#: internal operator names -> user-facing spellings for error messages
DISPLAY_NAMES = {
    "__add": "+", "__sub": "-", "__mul": "*", "__div": "/", "__mod": "%",
    "__pow": "^", "__eq": "==", "__ne": "!=", "__lt": "<", "__gt": ">",
    "__le": "<=", "__ge": ">=", "__and": "&&", "__or": "||",
    "__xor": "xor", "__neg": "unary -", "__not": "!",
}

#: builtins of the JAX package that this package does not have yet, with
#: the ROADMAP item that ports them; calling one raises NotImplementedError
NOT_PORTED: dict = {}


def display(name: str) -> str:
    return DISPLAY_NAMES.get(name, name)


def builtin(name: str, *aliases: str):
    def deco(fn):
        BUILTINS[name] = fn
        for alias in aliases:
            BUILTINS[alias] = fn
        return fn

    return deco


def not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


def is_builtin(name: str) -> bool:
    """A name of the language's builtin table: ported or not (the
    reference's registry holds both)."""
    return name in BUILTINS or name in NOT_PORTED


def lookup(name: str):
    fn = BUILTINS.get(name)
    if fn is None and name in NOT_PORTED:
        raise not_ported(f"builtin {name!r}", NOT_PORTED[name])
    return fn


# ---------------------------------------------------------------------------
# Overload / broadcasting helpers
# ---------------------------------------------------------------------------

def result_tag(a: TupleValue, b: TupleValue) -> str:
    """Tag of an elementwise binary result: equal tags keep the tag; a
    length-1 nil operand adopts the other side's tag; otherwise nil."""
    if a.tag == b.tag:
        return a.tag
    if a.tag == NIL and a.length == 1:
        return b.tag
    if b.tag == NIL and b.length == 1:
        return a.tag
    return NIL


def broadcast_pair(a: TupleValue, b: TupleValue, span, opname: str):
    """Aligned component pairs under MathMap broadcast rules: equal
    lengths zip; length-1 broadcasts against length-n."""
    if a.is_opaque or b.is_opaque:
        raise MMTypeError(
            f"operator {display(opname)!r} not defined on {a.tag}/{b.tag}", span
        )
    la, lb = a.length, b.length
    if la == lb:
        return list(zip(a.arrays, b.arrays))
    if la == 1:
        return [(a.arrays[0], y) for y in b.arrays]
    if lb == 1:
        return [(x, b.arrays[0]) for x in a.arrays]
    raise MMTypeError(
        f"operator {display(opname)!r}: tuple lengths {la} and {lb} do not match", span
    )


def ew2(opname: str, fn) -> None:
    """Register a plain elementwise binary builtin: fn(x, y) on tensors."""

    @builtin(opname)
    def _op(ev, args, span, _fn=fn, _name=opname):
        a, b = need_args(args, 2, _name, span)
        pairs = broadcast_pair(a, b, span, _name)
        return TupleValue(result_tag(a, b), tuple(_fn(x, y) for x, y in pairs))


def ew1(opname: str, fn, *aliases: str) -> None:
    """Register a plain elementwise unary builtin: fn(x) on tensors."""

    @builtin(opname, *aliases)
    def _op(ev, args, span, _fn=fn, _name=opname):
        (a,) = need_args(args, 1, _name, span)
        if a.is_opaque:
            raise MMTypeError(f"{_name!r} not defined on {a.tag}", span)
        return TupleValue(a.tag, tuple(_fn(x) for x in a.arrays))


def need_args(args, n: int, name: str, span):
    if len(args) != n:
        raise MMTypeError(f"{name!r} expects {n} argument(s), got {len(args)}", span)
    return args


def need_tag(v: TupleValue, tag: str, name: str, span) -> TupleValue:
    if v.tag != tag:
        raise MMTypeError(f"{name!r} expects a {tag}: tuple, got {v.tag}:", span)
    return v


def need_length(v: TupleValue, n: int, name: str, span) -> TupleValue:
    if v.is_opaque:
        raise MMTypeError(
            f"{name!r} expects a length-{n} tuple, got a {v.tag} value",
            span)
    if v.length != n:
        raise MMTypeError(f"{name!r} expects a length-{n} tuple, got length {v.length}", span)
    return v


# the builtins register themselves through `builtin` above
from . import builtins  # noqa: E402,F401
