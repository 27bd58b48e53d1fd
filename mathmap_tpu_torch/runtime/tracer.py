"""Whole-grid evaluator on torch tensors (the port of the NumPy-oracle
branch of `mathmap_tpu/runtime/tracer.py`).

`x`/`y` are bound to whole-grid (H, W) coordinate tensors and the AST is
evaluated ONCE: every scalar op of the per-pixel program becomes one
elementwise torch op over the grid, run eagerly on the context's device.
`if` evaluates both branches and merges assigned variables with a `where`
phi on the condition mask (the language is pure apart from local
assignment). Image application goes to runtime.sampling, whose CUDA path is
the hand-written sampler kernel.

`while` loops run in `_eval_While`, after a probe that learns the carried
names' lengths and tags, or the loop's memo of an earlier probe under the
same key (runtime/loops.py::probe_outcome): unrolled when the trip count
folds to a constant, else through the generated kernel B3 when the loop is
eligible (runtime/loops.py, the loop's front end, hands it to
kernels/while_loop.py; `SymEvaluator` and `trace` below turn its step into
B3's op list), else as the masked eager loop, which a program traced by
torch.export holds as torch's while loop instead. Each loop run of a
render counts its route in the counters `loop.<route>` and
`loop.<route>.steps` (utils/trace.py).
Curves and gradients apply through kernel B2 (ops/color_ops.py).

rand() draws from a counter hash of the global pixel index (ops/rand.py):
each draw takes the context's next counter, and inside a loop every step
restarts from the same counter while the iteration number salts the draw,
so the unroll, kernel B3 and the masked loop draw the same values.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..kernels.while_loop import (ITERATION, GeneratorError, Program, any_active,
                                  while_loop_reference)
from ..lang import astnodes as A
from ..ops import libm
from ..ops import registry as R
from ..ops.color_ops import apply_curve, apply_gradient
from ..ops.rand import draw_salt, mix_salt, rand_index, rand_uniform
from ..typesys import tags as tagmod
from ..typesys.tags import NIL
from ..utils.constants import constant
from ..utils.errors import MMNameError, MMRuntimeError, MMTypeError
from ..utils.trace import count, span
from .loops import (SCALAR_INTERNALS, Loop, dependencies, eligible, probe_key,
                    probe_outcome, scalar_internal, while_loop_exported)
from .loops import while_loop as loop_kernel
from .value import ClosureImage, TupleValue, image_value

_LITERAL = span("mm.sync.literal")
_LOOP = span("mm.sync.loop")
_PROBE = span("mm.loop.probe")
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


def _any_active(mask) -> bool:
    """The eager masked loop's check: the mask read on the host, a wait on
    the device."""
    with _LOOP:
        return any_active(mask)


def _count_route(route: str, steps: int) -> None:
    """One loop run on `route` (`unroll`, `kernel` or `masked`) and the
    steps it ran, the unroll's before it included; the kernel, whose steps
    run on the device, adds its bound, max_loop_iters. Under torch.export
    nothing counts (utils/trace.py): the exported graph shows the route,
    torch's `while_loop` op among them."""
    count(f"loop.{route}")
    count(f"loop.{route}.steps", steps)


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
    #: animation time and the `frame` internal: floats, or 0-d tensors on
    #: the device when an exported program takes them as inputs
    #: (generators/artifact.py)
    t: Any = 0.0
    frame: Any = 0.0
    #: component dtype of every grid and literal
    dtype: torch.dtype = torch.float32
    #: filter-inlining depth (recursive filters would inline forever)
    inline_depth: int = 0
    max_inline_depth: int = 32
    #: >0 while a while loop's steps are evaluated (unroll, kernel route,
    #: masked loop; not its probe): the tiled renderer's halo check skips
    #: samples there, as the reference's does
    loop_depth: int = 0
    #: this tile's (rows, cols) when the grid is split over a mesh
    #: (parallel/); None = the whole (height, width) frame. The internals
    #: X, Y, W, H and R always use the global size.
    grid_shape: tuple | None = None
    #: the tile's global (row, col) origin
    row_offset: int = 0
    col_offset: int = 0
    #: rand() draws so far: the next draw takes the next counter
    rand_counter: int = 0
    #: loops begun at this level so far; offsets a loop's counters, so two
    #: loops in sequence draw different streams
    rand_loop_nonce: int = 0
    #: (id(source pixels), stddev) -> (source pixels, blurred InputImage):
    #: gaussian_blur's per-render cache (runtime/native_filters.py)
    native_cache: dict = field(default_factory=dict)

    @property
    def shape(self):
        if self.grid_shape is not None:
            return self.grid_shape
        return (self.height, self.width)


class Evaluator:
    def __init__(self, ctx: RenderContext, x, y, env: dict, salt_extra=None):
        self.ctx = ctx
        self.x = x
        self.y = y
        self.env = env
        self._cache: dict = {}
        #: the iteration salt of the loop step this evaluation is in (below
        #: 2^32: an int, or a 0-d int64 tensor inside an exported while
        #: loop; None outside loops): every iteration draws afresh
        self.salt_extra = salt_extra

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def lit(self, v) -> torch.Tensor:
        """A constant on the render device in the render dtype, uploaded
        once per process (utils/constants.py): the first use on a card is
        a copy from the host that waits for the device's queue."""
        return constant(_LITERAL, v, self.ctx.dtype, self.ctx.device)

    def grid(self, arr):
        """Broadcast a component to the full (H, W) grid."""
        return torch.broadcast_to(arr, self.ctx.shape)

    def rand_uniform(self):
        """One draw in [0, 1) per pixel: the context's next counter, salted
        with the loop iteration this evaluation is in."""
        ctx = self.ctx
        ctx.rand_counter += 1
        index = rand_index(ctx.shape, ctx.width, ctx.row_offset, ctx.col_offset, ctx.device)
        return rand_uniform(index, draw_salt(ctx.opts.seed, ctx.rand_counter), self.salt_extra)

    def _mix_salt(self, loop_i):
        """The salt of iteration `loop_i` of a loop evaluated here: the
        iteration number, mixed with the enclosing loop's salt when this
        evaluation is itself inside a loop. Either may be a 0-d int64
        tensor (an exported while loop's iteration number)."""
        if self.salt_extra is None:
            return loop_i
        return mix_salt(self.salt_extra, loop_i)

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

    @contextlib.contextmanager
    def _in_loop(self):
        """Raise ctx.loop_depth while a loop's body or condition runs."""
        self.ctx.loop_depth += 1
        try:
            yield
        finally:
            self.ctx.loop_depth -= 1

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
            v = TupleValue(NIL, (libm.sqrt(self.x * self.x + self.y * self.y),))
        elif name == "a":
            # angle in [0, 2pi) counterclockwise from +x
            v = TupleValue(NIL, (torch.remainder(libm.atan2(self.y, self.x), _2PI),))
        elif name in ("t", "frame"):
            # a new value every frame: uploaded each time, never kept
            value = getattr(ctx, name)
            if not isinstance(value, torch.Tensor):
                value = _LITERAL.tensor(value, ctx.dtype, ctx.device)
            v = TupleValue(NIL, (value,))
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

    # ------------------------------------------------------------------
    # while loops
    # ------------------------------------------------------------------
    def _probe(self, node: A.While) -> dict:
        """A loop's probe: its condition and body evaluated once on a
        scratch env -> {carried name: (length, tag)} at the end, all that
        is kept, the names in sorted order. The tensors are discarded, and
        rand()'s counters go back to their state before it."""
        names = sorted(A.assigned_names(node.body) | A.assigned_names(node.cond))
        counter_entry, nonce_entry = self.ctx.rand_counter, self.ctx.rand_loop_nonce
        probe_env = dict(self.env)
        probe = Evaluator(self.ctx, self.x, self.y, probe_env)
        for n in names:
            if n not in probe_env:
                # an assigned-but-undeclared internal-named variable (y, t,
                # ...) starts as the internal: a first read in the loop sees
                # the coordinate, not zero (the if-phi merge's rule)
                iv = self._internal(n)
                probe_env[n] = iv if iv is not None else TupleValue(NIL, (self.lit(0.0),))
        # at loop depth 0, as the reference's probe runs: the tiled
        # renderer's halo check measures its samples
        with _PROBE:
            if node.post:
                # do-while: the body runs before the first condition
                probe.eval(node.body)
                probe.eval(node.cond)
            else:
                probe.eval(node.cond)
                probe.eval(node.body)
        self.ctx.rand_counter, self.ctx.rand_loop_nonce = counter_entry, nonce_entry
        return {n: (probe_env[n].length, probe_env[n].tag) for n in names}

    def _eval_While(self, node: A.While) -> TupleValue:
        """The reference's `_eval_While`: a probe finds the carried names'
        lengths and tags (kept in the loop's memo, runtime/loops.py::
        probe_outcome, for the frames that follow), then the loop runs on
        one of three routes, each run counted in `loop.<route>`
        (_count_route): the static-trip-count unroll when
        the condition const-folds, the generated kernel B3 for an eligible
        loop (its plain version on the CPU), or the masked eager loop;
        under torch.export the masked loop is torch's while loop, whose
        steps the exported program runs with the same values."""
        # rand(): the unroll and the kernel fix a step's counters when they
        # evaluate or trace it, the masked loop draws step by step; so every
        # step restarts from one counter and its iteration number salts the
        # draws. The probe's draws are discarded with its results, and a
        # frame that finds its outcome in the loop's memo draws none.
        probed = probe_outcome(node, probe_key(self.env, self.ctx, self.salt_extra),
                               lambda: self._probe(node))

        shape = self.ctx.shape

        def widen(v: TupleValue, length: int, target_tag: str) -> TupleValue:
            if v.is_opaque:
                raise MMTypeError("image values cannot be loop variables", node.span)
            arrays = v.arrays
            if len(arrays) != length:
                if len(arrays) == 1:
                    arrays = arrays * length
                else:
                    raise MMTypeError(
                        f"loop variable changes tuple length "
                        f"{len(arrays)} -> {length}", node.span)
            tag = v.tag if v.tag != NIL else target_tag
            cst = None
            if v.const is not None:
                cs = v.const * length if len(v.const) == 1 and length > 1 else v.const
                if len(cs) == length:
                    cst = tuple(float(c) for c in cs)
            return TupleValue(tag, tuple(torch.broadcast_to(x, shape) for x in arrays),
                              const=cst)

        init_env = dict(self.env)
        carried: list[str] = []
        for n, (length, tag) in probed.items():
            if n not in init_env:
                iv = self._internal(n)
                if iv is not None and (iv.length == length or iv.length == 1):
                    # seed with the internal (a length-1 internal widens
                    # like any scalar carry); a longer internal carried at
                    # another length is write-before-read: zero seed
                    init_env[n] = iv
                else:
                    init_env[n] = TupleValue(NIL, (self.lit(0.0),), const=(0.0,))
            init_env[n] = widen(init_env[n], length, tag)
            carried.append(n)
        lengths = {n: init_env[n].length for n in carried}
        tags = {n: init_env[n].tag for n in carried}

        def pack(env):
            return tuple(a for n in carried for a in env[n].arrays)

        def unpack(flat, base_env=None, consts=None):
            env = dict(init_env if base_env is None else base_env)
            i = 0
            for n in carried:
                k = lengths[n]
                cst = None
                if consts is not None:
                    comps = consts[i:i + k]
                    if all(c is not None for c in comps):
                        cst = tuple(comps)
                env[n] = TupleValue(tags[n], tuple(flat[i:i + k]), const=cst)
                i += k
            return env

        def pack_const(env):
            """Per-slot host constants (None where unknown): the static
            unroll's carry, exactly lengths[n] slots per variable."""
            cs: list = []
            for n in carried:
                k = lengths[n]
                v = env[n]
                c = v.const if (v.const is not None
                                and len(v.const) == len(v.arrays)) else None
                if c is not None and len(c) != k:
                    c = tuple(c) * k if len(c) == 1 else None
                if c is not None:
                    cs.extend(float(x) for x in c)
                else:
                    cs.extend([None] * k)
            return tuple(cs)

        def repack(env, flat, mask, grid_shape):
            """Fold env's carried values back into the flat carry; `mask`
            selects the pixels that take the new value (None = all)."""
            new_flat = []
            i = 0
            for n in carried:
                k = lengths[n]
                new = env[n]
                if new.is_opaque:
                    raise MMTypeError(
                        f"loop variable {n!r}: image/curve/gradient values "
                        f"cannot be loop variables", node.span)
                if new.length != k:
                    if new.length == 1:
                        new = TupleValue(tags[n], new.arrays * k)
                    else:
                        raise MMTypeError(
                            f"loop variable {n!r} changes tuple length inside loop",
                            node.span)
                for j in range(k):
                    if mask is None:
                        new_flat.append(torch.broadcast_to(new.arrays[j], grid_shape))
                    else:
                        new_flat.append(torch.where(mask, new.arrays[j], flat[i + j]))
                i += k
            return tuple(new_flat)

        #: trace-time truth of the latest condition (None = per pixel)
        cond_const = [None]
        #: pack_const() of the env after the latest const-threaded condition
        carry_consts = [None]

        def locate(tile):
            return tile or (self.ctx, self.x, self.y, None, Evaluator)

        def eval_cond(flat, mask, salt, tile=None, consts=None):
            """Evaluate the condition on the carried env, drawing with the
            iteration salt `salt`; its assignments persist for the pixels
            that evaluated it (those in `mask`)."""
            ctx, x, y, base_env, make_ev = locate(tile)
            env = unpack(flat, base_env, consts=consts)
            ev = make_ev(ctx, x, y, env, salt)
            cond_tv = ev.eval(node.cond)
            cond_mask = ev._truthy_mask(cond_tv, node.span)
            c = cond_tv.const
            cond_const[0] = bool(c[0] != 0) if c is not None and len(c) == 1 else None
            carry_consts[0] = pack_const(env) if consts is not None else None
            return repack(env, flat, mask, ctx.shape), cond_mask

        def step(flat, mask, loop_i, tile=None, consts=None):
            """Iteration `loop_i` (counted from 1; an int, or a 0-d int64
            tensor in an exported while loop) under `mask` -> (new flat,
            next mask). mask=None steps every pixel and returns the
            condition unmerged. `tile` = (ctx, x, y, base_env,
            make_evaluator) evaluates the step there: `trace` runs it on
            symbolic scalars."""
            ctx, x, y, base_env, make_ev = locate(tile)
            ctx.rand_counter, ctx.rand_loop_nonce = rand_base, nonce_loop
            salt = self._mix_salt(loop_i)
            env = unpack(flat, base_env, consts=consts)
            make_ev(ctx, x, y, env, salt).eval(node.body)
            new_flat = repack(env, flat, mask, ctx.shape)
            new_flat, cond_mask = eval_cond(
                new_flat, mask, salt, tile=tile,
                consts=pack_const(env) if consts is not None else None)
            return new_flat, (cond_mask if mask is None else mask & cond_mask)

        flat0 = pack(init_env)
        consts0 = pack_const(init_env)
        if node.post:
            # do-while: run the body once for every pixel first; its result
            # carries no constants
            env = unpack(flat0)
            Evaluator(self.ctx, self.x, self.y, env, self.salt_extra).eval(node.body)
            flat0 = repack(env, flat0, None, shape)
            consts0 = tuple(None for _ in consts0)
        flat0, mask0 = eval_cond(flat0, None, self.salt_extra, consts=consts0)
        cond0 = cond_const[0]
        consts0 = carry_consts[0]
        mask0 = torch.broadcast_to(mask0, shape)
        # every step starts from these counters (step() resets them)
        counter_loop, nonce = self.ctx.rand_counter, self.ctx.rand_loop_nonce
        nonce_loop = nonce + 1
        rand_base = counter_loop + nonce * 1000003
        self.ctx.rand_loop_nonce = nonce_loop

        def finish(flat, consts=None):
            """Bind the loop's results. The steps a route ran depend on the
            data, so the counters go back to their state after the first
            condition: a draw after the loop is the same on every route, and
            a sibling loop starts from the next nonce."""
            self.ctx.rand_counter, self.ctx.rand_loop_nonce = counter_loop, nonce_loop
            final_env = unpack(flat, consts=consts)
            for n in carried:
                self.env[n] = final_env[n]
            return TupleValue(NIL, (self.lit(0.0),))

        opts = self.ctx.opts
        max_iters = int(opts.max_loop_iters)
        loop = None
        # a loop inside another loop's step draws with its enclosing salt,
        # which the kernel does not take: it never goes to the kernel, as in
        # the reference; nor does a loop of the float64 spec render, which
        # the reference's oracle runs as the masked loop (B3 is float32)
        if (opts.pallas_while != "off" and self.salt_extra is None
                and self.ctx.dtype == torch.float32
                and eligible(node, self.env, self.ctx.filters)):
            deps = dependencies(node, init_env, carried, shape)
            if deps is not None:
                spec = (tuple((n, lengths[n], tags[n]) for n in carried),
                        tuple((n, tv.tag, len(tv.arrays)) for n, tv in deps))
                loop = Loop(step=step, trace=trace, deps=deps, x=self.x, y=self.y,
                            ctx=self.ctx, unroll=opts.while_unroll, node=node, spec=spec,
                            rand_base=rand_base)

        # static-trip-count unroll: while the condition folds to a constant,
        # step every pixel (no masks, no convergence checks). 'on' forces
        # the kernel over it, as the reference's pallas_while does.
        n_done = 0
        if (cond0 is not None and opts.while_static_unroll > 0
                and not (loop is not None and opts.pallas_while == "on")):
            flat_u, consts_u, active = flat0, consts0, cond0
            with self._in_loop():
                while active and n_done < max_iters and n_done < opts.while_static_unroll:
                    flat_u, mask_u = step(flat_u, None, n_done + 1, consts=consts_u)
                    consts_u = carry_consts[0]
                    n_done += 1
                    active = cond_const[0]
            if active is False or (active and n_done >= max_iters):
                _count_route("unroll", n_done)
                return finish(flat_u, consts_u)
            # the condition stopped folding (or the budget ran out) after
            # n_done steps that every pixel took: go on from there with the
            # last condition as the mask, instead of discarding those steps;
            # the next iteration is number n_done + 1, as in the reference
            flat0 = flat_u
            mask0 = torch.broadcast_to(mask_u, shape)

        with self._in_loop():
            if loop is not None:
                loop.it_base = n_done
                flat_out = loop_kernel(loop, flat0, mask0, max_iters - n_done)
                _count_route("kernel", max_iters)
            elif torch.compiler.is_exporting():
                # the masked loop's check reads the mask on the host: an
                # exported program holds it as torch's while loop, whose
                # traced body's blurs must not outlive it
                cache = dict(self.ctx.native_cache)
                flat_out = while_loop_exported(
                    step, flat0, mask0, max_iters - n_done, opts.while_unroll, n_done)
                self.ctx.native_cache = cache
            else:
                flat_out, steps = while_loop_reference(
                    step, flat0, mask0, max_iters - n_done, opts.while_unroll, n_done,
                    check=_any_active)
                _count_route("masked", n_done + steps)
        return finish(flat_out)

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
            if len(node.args) != 1:
                raise MMTypeError(f"{v.tag} application expects one argument", span)
            apply = apply_curve if v.tag == "curve" else apply_gradient
            return apply(self, v.payload, self.eval(node.args[0]), span)
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
        # an inlined filter draws with the caller's iteration salt
        ev = Evaluator(self.ctx, x, y, env, self.salt_extra)
        self.ctx.inline_depth += 1
        try:
            out = ev.eval(fdef.body)
        finally:
            self.ctx.inline_depth -= 1
        return coerce_rgba(ev, out, fdef)


class SymEvaluator(Evaluator):
    """The evaluator over kernel B3's symbolic per-pixel scalars
    (kernels/while_loop.py::Sym), recording into `program`: its literals
    are the Program's constants, a rand() draw is one `rand` op, and the
    scalar internals are kernel arguments."""

    def __init__(self, program: Program, ctx: RenderContext, x, y, env: dict,
                 salt_extra=None):
        super().__init__(ctx, x, y, env, salt_extra)
        self.program = program

    def lit(self, v):
        return self.program.const(v)

    def rand_uniform(self):
        # the step's k-th draw; the kernel salts it with the iteration
        self.ctx.rand_counter += 1
        if self.salt_extra is not ITERATION:
            raise GeneratorError("a rand() draw with another salt than the iteration's")
        k = self.ctx.rand_counter - self.program.rand_base
        return self.program.add("rand", (("n", k),), "f")

    def _internal(self, name):
        # the size internals keep their host constants, as in the
        # evaluator; t and frame have none
        if name in SCALAR_INTERNALS:
            c = None if name in ("t", "frame") else scalar_internal(self.ctx, name)
            return TupleValue(NIL, (self.program.input(("scalar", name)),),
                              const=None if c is None else (c,))
        if name in ("WH", "wh"):
            return TupleValue(NIL, (self.program.input(("scalar", "W")),
                                    self.program.input(("scalar", "H"))),
                              const=(float(self.ctx.width), float(self.ctx.height)))
        return super()._internal(name)


def trace(loop: Loop, n_flat: int) -> Program:
    """Run the loop's step once on symbolic inputs -> its Program."""
    prog = Program(loop.rand_base, loop.origin)
    flat = tuple(prog.input(("carry", i)) for i in range(n_flat))
    base_env = {name: TupleValue(tv.tag, tuple(prog.input(("dep", name, j))
                                               for j in range(len(tv.arrays))))
                for name, tv in loop.deps}
    x, y = prog.input(("x",)), prog.input(("y",))

    def make_evaluator(ctx, ex, ey, env, salt_extra):
        return SymEvaluator(prog, ctx, ex, ey, env, salt_extra)

    new_flat, cond = loop.step(flat, None, ITERATION,
                               tile=(loop.ctx, x, y, base_env, make_evaluator))
    prog.outputs = [prog.operand(v) for v in new_flat]
    prog.cond = prog.operand(cond)
    if prog.kind_of(prog.cond) != "b" or any(prog.kind_of(o) != "f" for o in prog.outputs):
        raise GeneratorError("a loop step must give float carries and a bool condition")
    return prog


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
