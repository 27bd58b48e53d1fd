"""Whole-grid evaluator on torch tensors (the port of the NumPy-oracle
branch of `mathmap_tpu/runtime/tracer.py`).

`x`/`y` are bound to whole-grid (H, W) coordinate tensors and the AST is
evaluated ONCE: every scalar op of the per-pixel program becomes one
elementwise torch op over the grid, run eagerly on the context's device.
`if` evaluates both branches and merges assigned variables with a `where`
phi on the condition mask (the language is pure apart from local
assignment). Image application goes to runtime.sampling, whose CUDA path is
the hand-written sampler kernel.

Not ported yet: `while` loops and rand() (ROADMAP A3, with kernel B3 in
A6), curve and gradient application (kernel B2, ROADMAP A6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..lang import astnodes as A
from ..ops import registry as R
from ..runtime.value import ClosureImage, TupleValue, image_value
from ..typesys import tags as tagmod
from ..typesys.tags import NIL
from ..utils.errors import MMNameError, MMRuntimeError, MMTypeError

_2PI = 2.0 * math.pi

#: operator token -> builtin name
_BINOP_NAME = {
    "+": "__add", "-": "__sub", "*": "__mul", "/": "__div", "%": "__mod",
    "^": "__pow", "==": "__eq", "!=": "__ne", "<": "__lt", ">": "__gt",
    "<=": "__le", ">=": "__ge", "&&": "__and", "||": "__or", "xor": "__xor",
}
_UNOP_NAME = {"-": "__neg", "!": "__not"}

#: builtins safe to constant-fold on the host: pure scalar arithmetic (no
#: images, no context state) — the same set as the reference's
_CONST_FOLD_OPS = frozenset({
    "__add", "__sub", "__mul", "__div", "__mod", "__pow",
    "__eq", "__ne", "__lt", "__gt", "__le", "__ge",
    "__and", "__or", "__xor", "__neg", "__not",
    "abs", "sign", "min", "max", "clamp", "floor", "ceil", "round",
    "fmod", "sqrt", "exp", "log", "pow",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "exp2", "log2", "log10", "deg2rad", "rad2deg", "hypot",
    "lerp", "smoothstep", "inintv",
    "conj", "rgbaColor", "rgbColor", "grayColor", "grayaColor", "gray",
})


@dataclass
class RenderContext:
    """Per-invocation state: the frame geometry, options, inputs and the
    device every tensor of the render lives on."""

    device: torch.device
    width: int
    height: int
    opts: Any  # RenderOptions
    inputs: list = field(default_factory=list)  # list[InputImage]
    filters: dict = field(default_factory=dict)  # name -> FilterDef
    t: float = 0.0  # animation time
    frame: float = 0.0
    #: component dtype of every grid and literal
    dtype: torch.dtype = torch.float32
    #: filter-inlining depth (recursive filters would inline forever)
    inline_depth: int = 0
    max_inline_depth: int = 32

    @property
    def shape(self):
        return (self.height, self.width)


class Evaluator:
    def __init__(self, ctx: RenderContext, x, y, env: dict):
        self.ctx = ctx
        self.x = x
        self.y = y
        self.env = env
        self._cache: dict = {}

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def lit(self, v) -> torch.Tensor:
        """A constant on the render device in the render dtype."""
        return torch.tensor(v, dtype=self.ctx.dtype, device=self.ctx.device)

    def grid(self, arr):
        """Broadcast a component to the full (H, W) grid."""
        return torch.broadcast_to(arr, self.ctx.shape)

    def _truthy_mask(self, v: TupleValue, span):
        if v.is_opaque or v.length != 1:
            raise MMTypeError("condition must be a single value", span)
        return v.arrays[0] != 0

    def _select(self, mask, a: TupleValue, b: TupleValue, span) -> TupleValue:
        if a.is_opaque or b.is_opaque:
            if a.payload is b.payload:
                return a
            raise MMTypeError("cannot merge image/curve/gradient values across branches", span)
        pairs = R.broadcast_pair(a, b, span, "if")
        return TupleValue(R.result_tag(a, b), tuple(torch.where(mask, x, y) for x, y in pairs))

    def _zero_like(self, v: TupleValue) -> TupleValue:
        return TupleValue(v.tag, tuple(torch.zeros_like(x) for x in v.arrays))

    # ------------------------------------------------------------------
    # variable resolution
    # ------------------------------------------------------------------
    def _internal(self, name: str):
        if name in self._cache:
            return self._cache[name]
        ctx = self.ctx
        v = None
        if name == "x":
            v = TupleValue(NIL, (self.x,))
        elif name == "y":
            v = TupleValue(NIL, (self.y,))
        elif name == "r":
            v = TupleValue(NIL, (torch.sqrt(self.x * self.x + self.y * self.y),))
        elif name == "a":
            # angle in [0, 2pi) counterclockwise from +x
            v = TupleValue(NIL, (torch.remainder(torch.atan2(self.y, self.x), _2PI),))
        elif name == "t":
            v = TupleValue(NIL, (self.lit(ctx.t),))
        elif name == "frame":
            v = TupleValue(NIL, (self.lit(ctx.frame),))
        elif name == "X":
            v = TupleValue(NIL, (self.lit(ctx.width * 0.5),),
                           const=(ctx.width * 0.5,))
        elif name == "Y":
            v = TupleValue(NIL, (self.lit(ctx.height * 0.5),),
                           const=(ctx.height * 0.5,))
        elif name == "W":
            v = TupleValue(NIL, (self.lit(float(ctx.width)),),
                           const=(float(ctx.width),))
        elif name == "H":
            v = TupleValue(NIL, (self.lit(float(ctx.height)),),
                           const=(float(ctx.height),))
        elif name == "R":
            _R = ((ctx.width * 0.5) ** 2 + (ctx.height * 0.5) ** 2) ** 0.5
            v = TupleValue(NIL, (self.lit(_R),), const=(_R,))
        elif name == "xy":
            v = TupleValue("xy", (self.x, self.y))
        elif name == "WH" or name == "wh":
            v = TupleValue(NIL, (self.lit(float(ctx.width)), self.lit(float(ctx.height))),
                           const=(float(ctx.width), float(ctx.height)))
        elif name == "pi":
            v = TupleValue(NIL, (self.lit(math.pi),), const=(math.pi,))
        elif name == "e":
            v = TupleValue(NIL, (self.lit(math.e),), const=(math.e,))
        elif name == "I":
            v = TupleValue("ri", (self.lit(0.0), self.lit(1.0)),
                           const=(0.0, 1.0))
        if v is not None:
            self._cache[name] = v
        return v

    def _lookup(self, name: str, span) -> TupleValue:
        if name in self.env:
            return self.env[name]
        v = self._internal(name)
        if v is not None:
            return v
        if name in self.ctx.filters:
            return image_value(ClosureImage(self.ctx.filters[name], (), name=name))
        raise MMNameError(f"unknown variable {name!r}", span)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval(self, node) -> TupleValue:
        method = getattr(self, "_eval_" + type(node).__name__, None)
        if method is None:
            raise MMRuntimeError(f"cannot evaluate node {type(node).__name__}", node.span)
        return method(node)

    def _eval_Num(self, node: A.Num) -> TupleValue:
        return TupleValue(NIL, (self.lit(node.value),), const=(node.value,))

    def _eval_Var(self, node: A.Var) -> TupleValue:
        return self._lookup(node.name, node.span)

    def _eval_TupleLit(self, node: A.TupleLit) -> TupleValue:
        comps = []
        consts: list = []
        for item in node.items:
            v = self.eval(item)
            comps.append(v.scalar(item.span))
            consts.append(v.const[0] if v.const is not None
                          and len(v.const) == 1 else None)
        cst = tuple(consts) if all(c is not None for c in consts) else None
        return TupleValue(NIL, tuple(comps), const=cst)

    def _eval_Cast(self, node: A.Cast) -> TupleValue:
        v = self.eval(node.expr)
        want = tagmod.tag_length(node.tag)
        if v.is_opaque and node.tag != v.tag:
            raise MMTypeError(
                f"cannot retag {v.tag} value as {node.tag}:", node.span)
        if want is not None and not v.is_opaque and v.length != want:
            if v.length == 1:
                # scalar widens to the tag's arity (0 -> ri:[0,0] etc.)
                v = TupleValue(v.tag, v.arrays * want,
                               const=None if v.const is None
                               else v.const * want)
            else:
                raise MMTypeError(
                    f"cannot retag length-{v.length} tuple as {node.tag}: (length {want})",
                    node.span,
                )
        return v.retag(node.tag)

    def _eval_Subscript(self, node: A.Subscript) -> TupleValue:
        base = self.eval(node.base)
        if base.is_opaque:
            raise MMTypeError(f"cannot subscript {base.tag}", node.span)
        idx = self._static_index(node.index)
        if idx is not None:
            if not 0 <= idx < base.length:
                raise MMTypeError(
                    f"index {idx} out of range for length-{base.length} tuple", node.span
                )
            cst = (None if base.const is None
                   or len(base.const) != base.length
                   else (base.const[idx],))
            return TupleValue(NIL, (base.arrays[idx],), const=cst)
        # dynamic index: select chain (floor/clamp semantics)
        iv = self.eval(node.index).scalar(node.span)
        acc = base.arrays[0]
        for i in range(1, base.length):
            acc = torch.where(iv >= i, base.arrays[i], acc)
        return TupleValue(NIL, (acc,))

    def _static_index(self, node) -> int | None:
        if isinstance(node, A.Num) and float(node.value).is_integer():
            return int(node.value)
        return None

    def _fold_const(self, name: str, args, out: TupleValue) -> TupleValue:
        """Attach a host-side constant mirror to `out` when every argument
        carries one and the builtin is fold-safe: the SAME builtin runs on
        0-d CPU tensors of the context's dtype, so the mirror follows the
        render's arithmetic."""
        if (out.const is not None or out.is_opaque
                or name not in _CONST_FOLD_OPS or not args
                or any(a.const is None or a.is_opaque
                       or len(a.const) != len(a.arrays) for a in args)):
            return out
        shadow = [TupleValue(a.tag, tuple(torch.tensor(c, dtype=self.ctx.dtype)
                                          for c in a.const))
                  for a in args]
        res = R.lookup(name)(self, shadow, None)
        if not res.is_opaque and len(res.arrays) == len(out.arrays):
            out.const = tuple(float(c) for c in res.arrays)
        return out

    def _eval_BinOp(self, node: A.BinOp) -> TupleValue:
        name = _BINOP_NAME.get(node.op)
        if name is None:
            raise MMRuntimeError(f"unknown operator {node.op!r}", node.span)
        fn = R.lookup(name)
        args = [self.eval(node.left), self.eval(node.right)]
        return self._fold_const(name, args, fn(self, args, node.span))

    def _eval_UnOp(self, node: A.UnOp) -> TupleValue:
        name = _UNOP_NAME[node.op]
        fn = R.lookup(name)
        operand = self.eval(node.operand)
        return self._fold_const(name, [operand], fn(self, [operand], node.span))

    def _eval_Assign(self, node: A.Assign) -> TupleValue:
        v = self.eval(node.expr)
        self.env[node.name] = v
        return v

    def _eval_SubAssign(self, node: A.SubAssign) -> TupleValue:
        if node.name not in self.env:
            raise MMNameError(f"unknown variable {node.name!r}", node.span)
        base = self.env[node.name]
        if base.is_opaque:
            raise MMTypeError(f"cannot sub-assign into {base.tag}", node.span)
        rhs = self.eval(node.expr).scalar(node.span)
        idx = self._static_index(node.index)
        comps = list(base.arrays)
        if idx is not None:
            if not 0 <= idx < base.length:
                raise MMTypeError(
                    f"index {idx} out of range for length-{base.length} tuple", node.span
                )
            comps[idx] = rhs
        else:
            # the l-value names the component the dynamic read would
            # (_eval_Subscript's floor/clamp semantics)
            iv = self.eval(node.index).scalar(node.span)
            sel = torch.clamp(torch.floor(iv), 0.0, float(base.length - 1))
            for i in range(base.length):
                comps[i] = torch.where(sel == i, rhs, comps[i])
        self.env[node.name] = TupleValue(base.tag, tuple(comps))
        return TupleValue(NIL, (rhs,))

    def _eval_Seq(self, node: A.Seq) -> TupleValue:
        out = None
        for item in node.items:
            out = self.eval(item)
        return out

    def _eval_If(self, node: A.If) -> TupleValue:
        mask = self._truthy_mask(self.eval(node.cond), node.span)
        saved = self.env
        env_t = dict(saved)
        self.env = env_t
        v_t = self.eval(node.then)
        env_e = dict(saved)
        self.env = env_e
        v_e = self.eval(node.orelse) if node.orelse is not None else self._zero_like(v_t)
        self.env = saved
        # phi-merge assigned variables
        for k in set(env_t) | set(env_e):
            vt, ve = env_t.get(k), env_e.get(k)
            if vt is ve:
                if vt is not None:
                    saved[k] = vt
                continue

            # a branch-only assignment merges against the name's
            # PRE-BRANCH value: the outer binding, or the internal of that
            # name (y, t, ...), which is what the other branch would read
            def prior(other):
                if k in saved:
                    return saved[k]
                iv = self._internal(k)
                if iv is not None and iv.length in (1, other.length):
                    return iv
                return self._zero_like(other)

            if vt is None:
                vt = prior(ve)
            if ve is None:
                ve = prior(vt)
            saved[k] = self._select(mask, vt, ve, node.span)
        return self._select(mask, v_t, v_e, node.span)

    def _eval_While(self, node: A.While) -> TupleValue:
        raise R.not_ported("the per-pixel 'while' loop", "ROADMAP A3/A6")

    # ------------------------------------------------------------------
    # calls / application
    # ------------------------------------------------------------------
    def _eval_Call(self, node: A.Call) -> TupleValue:
        func = node.func
        if isinstance(func, A.Var):
            name = func.name
            # 1. a local/param holding an applicable value
            if name in self.env and self.env[name].is_opaque:
                return self._apply_value(self.env[name], node)
            # 2. a user-defined filter: build a closure image
            if name in self.ctx.filters and name not in self.env:
                fdef = self.ctx.filters[name]
                args = tuple(self.eval(a) for a in node.args)
                return image_value(ClosureImage(fdef, args, name=name))
            # 3. builtin
            fn = R.lookup(name)
            if fn is not None:
                args = [self.eval(a) for a in node.args]
                return self._fold_const(name, args, fn(self, args, node.span))
            raise MMNameError(f"unknown function {name!r}", node.span)
        # computed callee: must evaluate to an applicable value
        v = self.eval(func)
        if v.is_opaque:
            return self._apply_value(v, node)
        raise MMTypeError("cannot call a numeric tuple", node.span)

    def _apply_value(self, v: TupleValue, node: A.Call) -> TupleValue:
        span = node.span
        if v.tag == "image":
            if len(node.args) != 1:
                raise MMTypeError("image application expects one xy argument", span)
            p = self.eval(node.args[0])
            R.need_length(p, 2, "image application", span)
            x, y = self.grid(p.arrays[0]), self.grid(p.arrays[1])
            return TupleValue("rgba", tuple(v.payload.sample(self, x, y)))
        if v.tag in ("curve", "gradient"):
            raise R.not_ported(f"{v.tag} application (kernel B2)", "ROADMAP A6")
        raise MMTypeError(f"cannot apply value of type {v.tag}", span)

    # ------------------------------------------------------------------
    # filter invocation (closures / top level)
    # ------------------------------------------------------------------
    def eval_filter_at(self, fdef: A.FilterDef, args: tuple, x, y):
        """Evaluate `fdef` at coordinate grids (x, y): composition is
        inlining into the same evaluation."""
        if self.ctx.inline_depth >= self.ctx.max_inline_depth:
            raise MMRuntimeError(
                f"filter inlining exceeds depth {self.ctx.max_inline_depth} "
                f"(recursive filter {fdef.name!r}?)",
                fdef.span,
            )
        env = bind_params(self.ctx, fdef, args)
        ev = Evaluator(self.ctx, x, y, env)
        self.ctx.inline_depth += 1
        try:
            out = ev.eval(fdef.body)
        finally:
            self.ctx.inline_depth -= 1
        return coerce_rgba(ev, out, fdef)


def bind_params(ctx: RenderContext, fdef: A.FilterDef, args: tuple) -> dict:
    """Bind call arguments to filter params positionally; unbound params fall
    back to declared defaults."""
    from .uservals import default_userval

    env: dict = {}
    if len(args) > len(fdef.params):
        raise MMTypeError(
            f"filter {fdef.name!r} takes {len(fdef.params)} argument(s), got {len(args)}",
            fdef.span,
        )
    for i, p in enumerate(fdef.params):
        if i < len(args):
            env[p.name] = args[i]
        else:
            env[p.name] = default_userval(ctx, p)
    return env


def coerce_rgba(ev: Evaluator, out: TupleValue, fdef: A.FilterDef):
    """A filter's result must be a color; image results are sampled at the
    current coordinates."""
    if out.is_opaque and out.tag == "image":
        return out.payload.sample(ev, ev.grid(ev.x), ev.grid(ev.y))
    if out.is_opaque or out.length != 4:
        raise MMTypeError(
            f"filter {fdef.name!r} must return an rgba color (length-4 tuple), "
            f"got {out.tag}:{out.length}",
            fdef.span,
        )
    return tuple(ev.grid(c) for c in out.arrays)
