"""Kernel B3, the per-pixel `while` loop: eligibility, the CUDA generator,
the wrapper with its launch count, and the plain version.

The kernel replaces the JAX package's in-VMEM while engine
`mathmap_tpu/pallas_kernels/while_kernel.py::launch`. A loop's body differs
per filter, so its kernel is generated: the evaluator's own `step` closure
(runtime/tracer.py) runs ONCE on symbolic per-pixel scalars (`Sym`), whose
`__torch_function__` and arithmetic dunders record every torch op the
builtins reach into an SSA list (`Program`). `emit_cuda` prints that list
as C++, one line per op, into csrc/while_loop.cu.tmpl; kernels/build.py
compiles it with nvcc (`--fmad=false`) into a library of its own, cached per
process and on disk by a hash of the source. `run_program` interprets the
same list with torch, so the CPU tests hold the op list against the eager
loop and only the C spelling of each op is left to the card.

A rand() draw in the body is one op, `rand`, whose operand is the draw's
number within the step; the kernel hashes it in uint32 (`mm_rand`, the hash
of ops/rand.py) with the pixel's global index, the salt of the step's first
counter and the iteration number, all kernel arguments, so a new seed,
frame size or tile offset does not rebuild.

The kernel is the custom op `mathmap::while_loop`, whose first argument is
the Program as text (`Program.to_text`): the live render and an exported
program (generators/artifact.py) call it alike, so the loop's op list
travels with the program. Its CPU implementation, the plain version, is
`while_loop_reference`, the eager masked loop (the reference's oracle
loop with the lax route's `while_unroll` gating), stepping `run_program`
over the whole grid and merging each step under the mask: the same values
as stepping the evaluator's closure, which the tests hold bit for bit.

A loop the kernel does not take runs as that masked loop, stepping the
evaluator's closure; its `any()` check reads the mask on the host, which a
program traced by torch.export cannot do, so there `while_loop_exported`
writes it as torch's `while_loop` op with the same gated steps.

What bounds the kernel: operations (pixels x iterations x ops per
iteration), then the carried and dependency bytes read and written once,
and warp divergence (a warp runs until its slowest pixel exits).
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import operator
import string
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..ops import libm
from ..ops.rand import COUNTER, M32, draw_salt, rand_index, rand_uniform
from . import build

#: builtins a kernel body may call: the reference's SAFE_CALLS
#: (while_kernel.py). Its other exclusions (the internals `a`/`ra` and the
#: `ri:` overloads that reach atan2/sinh/cosh) were limits of the TPU's
#: Mosaic compiler; they do not apply here. The special functions (gamma,
#: lgamma, beta, ellK, ellE, Jacobi) stay off it, as in the reference,
#: where a specials-dense body ran slower in its engine than outside.
SAFE_CALLS = frozenset({
    "__add", "__sub", "__mul", "__div", "__mod", "__pow", "__eq", "__ne",
    "__lt", "__gt", "__le", "__ge", "__and", "__or", "__xor", "__neg",
    "__not",
    "abs", "sign", "min", "max", "clamp", "lerp", "smoothstep", "inintv",
    "floor", "ceil", "round", "fmod", "hypot",
    "sqrt", "exp", "exp2", "log", "log2", "log10", "pow",
    "sin", "cos", "tan", "tanh",
    "deg2rad", "rad2deg", "rand",
    "rgbColor", "rgbaColor", "grayColor", "grayaColor",
    "red", "green", "blue", "alpha", "gray",
    "toXY", "toHSVA", "toRGBA",
    "conj", "length", "dotp", "crossp", "normalize", "scale",
})

#: internals that are kernel scalar arguments rather than baked literals
SCALAR_INTERNALS = ("t", "frame", "X", "Y", "W", "H", "R")


def scalar_internal(ctx, name: str):
    """The value the evaluator's literal of a scalar internal holds: a
    float, or for `t` and `frame` the 0-d tensor of an exported program's
    input (generators/artifact.py)."""
    return {"t": ctx.t, "frame": ctx.frame, "X": ctx.width * 0.5,
            "Y": ctx.height * 0.5, "W": float(ctx.width), "H": float(ctx.height),
            "R": ((ctx.width * 0.5) ** 2 + (ctx.height * 0.5) ** 2) ** 0.5}[name]

TEMPLATE = Path(__file__).resolve().parent.parent / "csrc" / "while_loop.cu.tmpl"


def eligible(node, env: dict, filters: dict) -> bool:
    """Whether a loop (an A.While) can run as a generated kernel, decided
    from its AST: every call is a SAFE_CALLS builtin that no env value or
    user filter shadows, and no loop is nested in it."""
    from ..lang import astnodes as A

    for sub in A.walk(node):
        if isinstance(sub, A.Call):
            f = sub.func
            if not isinstance(f, A.Var) or f.name not in SAFE_CALLS:
                return False
            if f.name in env or f.name in filters:
                return False
        if isinstance(sub, A.While) and sub is not node:
            return False
    return True


def dependencies(node, init_env: dict, carried, shape) -> list | None:
    """The non-carried env values the loop (an A.While) reads, as (name,
    TupleValue) in name order; None when one is opaque or not a float32
    scalar or `shape` grid, which makes the loop ineligible."""
    from ..lang import astnodes as A

    reads = {s.name for s in A.walk(node) if isinstance(s, A.Var)}
    deps = []
    for name in sorted(reads):
        if name not in init_env or name in carried:
            continue
        tv = init_env[name]
        if tv.is_opaque or not all(
                a.dtype == torch.float32 and a.shape in ((), tuple(shape))
                for a in tv.arrays):
            return None
        deps.append((name, tv))
    return deps


@dataclass
class Loop:
    """One loop as the tracer hands it over: its step closure, the values
    it reads, and where it came from."""

    #: step(flat, mask, loop_i, tile=None) -> (flat, mask): iteration
    #: loop_i, counted from 1, under the mask (body, then the condition
    #: whose assignments persist); with mask=None every pixel steps and the
    #: condition mask comes back unmerged. tile=(ctx, x, y, base_env,
    #: make_evaluator) evaluates it there instead.
    step: Callable
    deps: list  # [(name, TupleValue)], dependencies()
    x: torch.Tensor
    y: torch.Tensor
    ctx: Any  # RenderContext
    unroll: int  # masked steps per convergence check (plain version)
    node: Any  # A.While
    #: what else fixes the traced ops: the carried names with their
    #: lengths and tags, and each dependency's name, tag and length
    spec: tuple
    #: the rand counter every step starts from: a step's k-th draw takes
    #: counter rand_base + k
    rand_base: int = 0
    #: iterations already run (the static unroll's): the first one here is
    #: number it_base + 1
    it_base: int = 0

    @property
    def origin(self) -> str:
        """Where the loop is, for the generated source's header."""
        return f"line {self.node.span.line}:{self.node.span.col}"

    @property
    def rand_salt(self) -> int:
        """The salt of counter rand_base (a step's draw k adds k * COUNTER)."""
        return draw_salt(self.ctx.opts.seed, self.rand_base)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def while_loop_reference(step, flat0, mask0, max_iters: int, unroll: int, it_base: int = 0):
    """The eager masked loop -> (final flat carry, steps run): `unroll`
    masked steps per `any()` check, none past `max_iters`, numbered from
    it_base + 1. A step past a pixel's exit leaves it as it was, so the
    count of checks changes no value."""
    flat, mask, i = flat0, mask0, 0
    while i < max_iters and bool(mask.any()):
        for _ in range(min(unroll, max_iters - i)):
            flat, mask = step(flat, mask, it_base + i + 1)
            i += 1
    return flat, i


def while_loop_exported(step, flat0, mask0, max_iters: int, unroll: int, it_base: int = 0):
    """The masked loop of while_loop_reference inside a program that
    torch.export traces -> the final flat carry. Its `any()` check cannot
    run on the host there, so the loop is torch's while loop (the
    higher-order op `while_loop`, which the exported program keeps and
    runs), the reference's lax route (mathmap_tpu/runtime/tracer.py): the
    carry is (i, mask, *flat), every iteration runs `unroll` masked steps,
    step k gated to the pixels in the mask while i + k < max_iters and
    numbered it_base + i + k + 1, a 0-d int64 tensor. A gated step leaves
    every pixel as it was, so the values are while_loop_reference's bit for
    bit. The carry is materialised as contiguous (H, W) tensors, the layout
    the op wants at every step. A loaded program runs the op as a host loop
    over the body's graph, reading the condition once an iteration, as the
    live masked loop reads its `any()`."""
    shape = mask0.shape
    carry = (torch.zeros((), dtype=torch.int64, device=mask0.device),
             *(torch.broadcast_to(t, shape).clone(memory_format=torch.contiguous_format)
               for t in (mask0, *flat0)))

    def cond(i, mask, *flat):
        return mask.any() & (i < max_iters)

    def body(i, mask, *flat):
        for k in range(unroll):
            flat, mask = step(flat, mask & ((i + k) < max_iters), it_base + i + (k + 1))
        return (i + unroll, mask, *flat)

    return _while_op(cond, body, carry)[2:]


def _while_op(cond, body, carry: tuple) -> tuple:
    """torch's `while_loop` op over `carry` inside a torch.export trace,
    with every tensor that `body` reads but does not take as an argument
    passed to the op as an input.

    torch's own `while_loop` lifts such tensors by tracing the body with
    dynamo, which refuses the evaluator (a step mutates the render
    context). So the body is traced here, as the op would trace it, into a
    graph in which each of those tensors is a constant: a tensor of the
    enclosing trace (x, y, an image, a param) or one the body made from
    Python data (a literal, the Perlin table). An exported program may
    hold neither inside a loop's graph, so each becomes a placeholder of
    the graph and the tensor an input of the op: the enclosing trace sees
    its own value or lifts the constant to the program's constants.
    `cond` reads only the carry."""
    from torch._higher_order_ops.utils import reenter_make_fx
    from torch._higher_order_ops.while_loop import while_loop_op
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    with disable_proxy_modes_tracing():
        gm = reenter_make_fx(lambda *c: tuple(body(*c)))(*(t.clone() for t in carry))
    graph = gm.graph
    last = [n for n in graph.nodes if n.op == "placeholder"][-1]
    lifted: dict = {}  # attribute -> (its tensor, the placeholder that replaces it)
    for node in list(graph.nodes):
        value = getattr(gm, node.target, None) if node.op == "get_attr" else None
        if isinstance(value, torch.Tensor):
            if node.target not in lifted:
                with graph.inserting_after(last):
                    last = graph.placeholder(f"lifted_{len(lifted)}")
                last.meta.update(node.meta)
                lifted[node.target] = (value, last)
            node.replace_all_uses_with(lifted[node.target][1])
            graph.erase_node(node)
    for name in lifted:
        delattr(gm, name)
    gm.recompile()
    n = len(carry)
    return while_loop_op(lambda *args: cond(*args[:n]), gm, carry,
                         tuple(value for value, _ in lifted.values()))


# ---------------------------------------------------------------------------
# tracing: symbolic per-pixel scalars -> SSA op list
# ---------------------------------------------------------------------------

class GeneratorError(NotImplementedError):
    """A torch op the generator cannot spell in CUDA: an eligible loop
    reached it, so the kernel cannot be built for that loop."""


#: torch function / dunder names -> SSA op names
_BINARY = {
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "sub", "subtract": "sub", "__sub__": "sub", "rsub": "rsub",
    "mul": "mul", "multiply": "mul", "__mul__": "mul", "__rmul__": "mul",
    "div": "div", "divide": "div", "true_divide": "div", "__truediv__": "div",
    "remainder": "remainder", "__mod__": "remainder", "fmod": "fmod",
    "pow": "pow", "__pow__": "pow", "atan2": "atan2", "arctan2": "atan2",
    "minimum": "minimum", "maximum": "maximum",
    "eq": "eq", "__eq__": "eq", "ne": "ne", "__ne__": "ne",
    "lt": "lt", "__lt__": "lt", "less": "lt", "gt": "gt", "__gt__": "gt",
    "greater": "gt", "le": "le", "__le__": "le", "ge": "ge", "__ge__": "ge",
    "__and__": "and", "bitwise_and": "and", "logical_and": "and",
    "__or__": "or", "bitwise_or": "or", "logical_or": "or",
    "__xor__": "xor", "bitwise_xor": "xor", "logical_xor": "xor",
}
_UNARY = {
    "neg": "neg", "negative": "neg", "__neg__": "neg",
    "__invert__": "not", "bitwise_not": "not", "logical_not": "not",
    "abs": "abs", "absolute": "abs", "reciprocal": "reciprocal",
    **{n: n for n in (
        "floor", "ceil", "round", "sign", "sqrt", "exp", "exp2", "log",
        "log2", "log10", "sin", "cos", "tan", "tanh", "asin", "acos",
        "atan", "sinh", "cosh", "asinh", "acosh", "atanh")},
}
_BOOL_RESULT = {"eq", "ne", "lt", "gt", "le", "ge", "and", "or", "xor", "not"}
_BOOL_OPERANDS = {"and", "or", "xor", "not", "to_float"}

#: the iteration number a traced step is given: the kernel computes it
ITERATION = object()
#: integer and float ops of one `rand` op in the kernel (mm_rand and the
#: salt's add), counted as operations in the kernel's bound
RAND_OPS = 15
#: of those, the integer ops (xor, shift, multiply, add of the hash), which
#: issue to the INT32 pipe, half as wide as the FP32 one
RAND_INT_OPS = 13
#: ops whose operands commute bit for bit (IEEE + and x; comparisons for
#: equality; logic)
_COMMUTATIVE = {"add", "mul", "eq", "ne", "and", "or", "xor"}


class Program:
    """An SSA list: ops[i] = (op, operands, kind); an operand is
    ("v", index) for an earlier op's value or ("s", float) for a Python
    scalar (PyTorch's CPU-scalar semantics); kind is "f" (float32) or "b"
    (bool). "in" ops name a kernel input, "const" ops a float32 or bool
    literal, and a "rand" op, operand ("n", k), the step's k-th draw."""

    def __init__(self, rand_base: int = 0, origin: str = ""):
        self.ops: list = []
        self.outputs: list = []  # operand per carried slot
        self.cond = None  # operand of the continue condition
        self._consts: dict = {}
        self._inputs: dict = {}
        #: the rand counter the traced step started from (Loop.rand_base)
        self.rand_base = rand_base
        #: where the loop is (Loop.origin), for the generated source's header
        self.origin = origin

    def add(self, op: str, operands: tuple, kind: str) -> "Sym":
        self.ops.append((op, operands, kind))
        return Sym(self, len(self.ops) - 1, kind)

    def input(self, key: tuple) -> "Sym":
        if key not in self._inputs:
            self._inputs[key] = self.add("in", (key,), "f")
        return self._inputs[key]

    def const(self, value) -> "Sym":
        if isinstance(value, (bool, np.bool_)):
            key, kind = ("b", bool(value)), "b"
        else:
            key, kind = ("f", float(np.float32(value))), "f"
        if key not in self._consts:
            self._consts[key] = self.add("const", (key[1],), kind)
        return self._consts[key]

    def operand(self, v):
        """A value met in a traced op -> its operand."""
        if isinstance(v, Sym):
            if v.program is not self:
                raise GeneratorError("a value from another loop's trace")
            return ("v", v.index)
        if isinstance(v, torch.Tensor):
            if v.numel() != 1:
                raise GeneratorError(
                    f"a {tuple(v.shape)} tensor inside a traced loop step")
            return ("v", self.const(v.reshape(()).item()).index)
        if isinstance(v, (bool, np.bool_)):
            return ("v", self.const(bool(v)).index)
        if isinstance(v, (int, float, np.integer, np.floating)):
            return ("s", float(v))
        raise GeneratorError(f"a {type(v).__name__} operand in a traced loop step")

    def kind_of(self, operand) -> str:
        return self.ops[operand[1]][2] if operand[0] == "v" else "f"

    @property
    def grid_inputs(self) -> list:
        """Input keys read through strides: ("carry", k), ("dep", name, j),
        ("x",), ("y",)."""
        return [k for k in self._inputs if k[0] != "scalar"]

    @property
    def scalar_inputs(self) -> list:
        """Input keys passed as float32 kernel arguments: ("scalar", name)."""
        return [k for k in self._inputs if k[0] == "scalar"]

    def n_compute_ops(self) -> int:
        """Operations a pixel iteration, a rand() draw counted as RAND_OPS."""
        return sum(RAND_OPS if op == "rand" else 1
                   for op, _, _ in self.ops if op not in ("in", "const"))

    def n_distinct_ops(self) -> int:
        """Operations a pixel iteration once every op that recomputes a
        value is merged into the one that first computes it, as a compiler
        keeps one copy: the same op on the same operands (a commutative
        op's in either order); a bool turned to float and compared != 0,
        which is the bool; an op on the carried inputs that the previous
        iteration computed on its outputs (the condition's z*z is the next
        body's); ops that read no carried value and no draw, which run once
        before the loop; and ops whose value nothing uses. A rand() draw
        counts RAND_OPS; each draw is its own."""
        rep = {}  # op index -> the operand that holds its value
        first = {}  # (op, operands) -> the op index that computes it
        carry = {}  # op index of an ("in", ("carry", k)) op -> k

        def key(op, args):
            return (op, tuple(sorted(args)) if op in _COMMUTATIVE else args)

        for i, (op, operands, _) in enumerate(self.ops):
            if op in ("in", "const"):
                rep[i] = ("v", i)
                if op == "in" and operands[0][0] == "carry":
                    carry[i] = operands[0][1]
                continue
            args = tuple(rep[o[1]] if o[0] == "v" else o for o in operands)
            if (op == "ne" and args[1] == ("s", 0.0) and args[0][0] == "v"
                    and self.ops[args[0][1]][0] == "to_float"):
                rep[i] = rep[self.ops[args[0][1]][1][0][1]]
                continue
            k = key(op, args)
            if op != "rand" and k in first:
                rep[i] = ("v", first[k])
                continue
            first[k] = i
            rep[i] = ("v", i)

        def value(o):
            return rep[o[1]] if o[0] == "v" else o

        outputs = [value(o) for o in self.outputs]
        # the value each op takes in the next iteration, where the previous
        # one computed it: carried inputs become this iteration's outputs
        image = {i: outputs[k] for i, k in carry.items()}
        carried = set()
        for k, i in first.items():
            op, args = k[0], self.ops[i][1]
            args = tuple(value(o) for o in args)
            if op == "rand" or not any(a[0] == "v" and a[1] in image for a in args):
                continue
            nxt = first.get(key(op, tuple(image.get(a[1], a) if a[0] == "v" else a
                                          for a in args)))
            if nxt is not None and nxt != i:
                image[i] = ("v", nxt)
                carried.add(i)
        varying = set(carry)
        for i in sorted(first.values()):
            op, operands, _ = self.ops[i]
            if op == "rand" or any(value(o)[1] in varying for o in operands if o[0] == "v"):
                varying.add(i)
        live, todo = set(), [o for o in (*outputs, value(self.cond)) if o[0] == "v"]
        while todo:
            i = todo.pop()[1]
            if i in live or self.ops[i][0] in ("in", "const"):
                continue
            live.add(i)
            todo += [value(o) for o in self.ops[i][1] if o[0] == "v"]
        return sum(RAND_OPS if self.ops[i][0] == "rand" else 1
                   for i in (live & varying) - carried)


    @property
    def draws(self) -> bool:
        """Whether a step draws rand()."""
        return any(op == "rand" for op, _, _ in self.ops)

    def to_text(self) -> str:
        """The program as JSON: the op list, outputs, condition, rand base
        and origin (Program.from_text reads it back). This string is the
        custom op `mathmap::while_loop`'s description of its loop, so an
        exported program carries the loop it runs."""
        return json.dumps({"ops": self.ops, "outputs": self.outputs, "cond": self.cond,
                           "rand_base": self.rand_base, "origin": self.origin},
                          separators=(",", ":"))

    @classmethod
    def from_text(cls, text: str) -> "Program":
        d = json.loads(text)
        prog = cls(d["rand_base"], d["origin"])
        for op, operands, kind in d["ops"]:
            if op == "in":
                key = tuple(operands[0])
                prog._inputs[key] = Sym(prog, len(prog.ops), kind)
                operands = (key,)
            elif op == "const":
                operands = tuple(operands)
            else:
                operands = tuple(tuple(o) for o in operands)
            prog.ops.append((op, operands, kind))
        prog.outputs = [tuple(o) for o in d["outputs"]]
        prog.cond = tuple(d["cond"])
        return prog


def _program_of(args) -> Program:
    for a in args:
        if isinstance(a, Sym):
            return a.program
        if isinstance(a, (tuple, list)):
            p = _program_of(a)
            if p is not None:
                return p
    return None


def _record(prog: Program, op: str, args) -> "Sym":
    operands = tuple(prog.operand(a) for a in args)
    kinds = [prog.kind_of(o) for o in operands]
    if op in _BOOL_OPERANDS:
        if any(k != "b" for k in kinds):
            raise GeneratorError(f"'{op}' on a non-bool value")
    elif op == "where":
        if kinds[0] != "b" or "b" in kinds[1:]:
            raise GeneratorError("where() needs a bool condition and float values")
    elif "b" in kinds:
        raise GeneratorError(f"'{op}' on a bool value")
    return prog.add(op, operands, "b" if op in _BOOL_RESULT else "f")


def _torch_op(func, args, kwargs):
    name = getattr(func, "__name__", str(func))
    kwargs = kwargs or {}
    prog = _program_of(args)
    if name in ("broadcast_to", "expand", "contiguous"):
        return args[0]
    if name == "broadcast_tensors":
        return tuple(args)
    if name in ("zeros_like", "ones_like"):
        one = name == "ones_like"
        return prog.const(float(one) if args[0].kind == "f" else one)
    if name == "clamp":
        lo = kwargs.get("min", args[1] if len(args) > 1 else None)
        hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        if not isinstance(lo, (int, float)) or not isinstance(hi, (int, float)):
            raise GeneratorError("clamp() with tensor or missing bounds")
        return _record(prog, "clamp", (args[0], lo, hi))
    if name == "where" and len(args) == 3 and not kwargs:
        return _record(prog, "where", args)
    if kwargs:
        raise GeneratorError(f"torch.{name} with keyword arguments")
    if name in _BINARY and len(args) == 2:
        op = _BINARY[name]
        if op == "rsub":  # rsub(a, b) = b - a
            return _record(prog, "sub", (args[1], args[0]))
        return _record(prog, op, args)
    if name in _UNARY and len(args) == 1:
        return _record(prog, _UNARY[name], args)
    raise GeneratorError(f"torch.{name} has no CUDA spelling in the loop generator")


class Sym:
    """A symbolic per-pixel float32 or bool scalar: one SSA value of the
    Program being traced. Torch functions and arithmetic on it append ops;
    anything that needs its value (bool(), float()) raises."""

    __slots__ = ("program", "index", "kind")
    __hash__ = object.__hash__

    def __init__(self, program: Program, index: int, kind: str):
        self.program = program
        self.index = index
        self.kind = kind

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _torch_op(func, args, kwargs)

    def _bin(self, op, other, reflected=False):
        args = (other, self) if reflected else (self, other)
        return _record(self.program, op, args)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, True)
    def __mod__(self, o): return self._bin("remainder", o)
    def __rmod__(self, o): return self._bin("remainder", o, True)
    def __pow__(self, o): return self._bin("pow", o)
    def __rpow__(self, o): return self._bin("pow", o, True)
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)
    def __ne__(self, o): return self._bin("ne", o)
    def __and__(self, o): return self._bin("and", o)
    def __rand__(self, o): return self._bin("and", o, True)
    def __or__(self, o): return self._bin("or", o)
    def __ror__(self, o): return self._bin("or", o, True)
    def __xor__(self, o): return self._bin("xor", o)
    def __rxor__(self, o): return self._bin("xor", o, True)
    def __neg__(self): return _record(self.program, "neg", (self,))
    def __invert__(self): return _record(self.program, "not", (self,))

    def to(self, dtype):
        if dtype != torch.float32:
            raise GeneratorError(f"conversion to {dtype} in a traced loop step")
        return _record(self.program, "to_float", (self,)) if self.kind == "b" else self

    def __bool__(self):
        raise GeneratorError("a traced per-pixel value was used as a Python bool")


@functools.cache
def _sym_evaluator_class():
    """Evaluator whose literals and scalar internals are Syms (imported
    late: runtime.tracer imports this module)."""
    from ..runtime.tracer import Evaluator
    from ..runtime.value import TupleValue
    from ..typesys.tags import NIL

    class SymEvaluator(Evaluator):
        def __init__(self, program, ctx, x, y, env, salt_extra=None):
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

    return SymEvaluator


def trace(loop: Loop, n_flat: int) -> Program:
    """Run the loop's step once on symbolic inputs -> its Program."""
    from ..runtime.value import TupleValue

    prog = Program(loop.rand_base, loop.origin)
    flat = tuple(prog.input(("carry", i)) for i in range(n_flat))
    base_env = {name: TupleValue(tv.tag, tuple(prog.input(("dep", name, j))
                                               for j in range(len(tv.arrays))))
                for name, tv in loop.deps}
    x, y = prog.input(("x",)), prog.input(("y",))
    cls = _sym_evaluator_class()

    def make_evaluator(ctx, ex, ey, env, salt_extra):
        return cls(prog, ctx, ex, ey, env, salt_extra)

    new_flat, cond = loop.step(flat, None, ITERATION,
                               tile=(loop.ctx, x, y, base_env, make_evaluator))
    prog.outputs = [prog.operand(v) for v in new_flat]
    prog.cond = prog.operand(cond)
    if prog.kind_of(prog.cond) != "b" or any(prog.kind_of(o) != "f" for o in prog.outputs):
        raise GeneratorError("a loop step must give float carries and a bool condition")
    return prog


# ---------------------------------------------------------------------------
# the CPU interpreter of a Program (the op list's executable spec)
# ---------------------------------------------------------------------------

_INTERP = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "remainder": torch.remainder, "fmod": torch.fmod,
    "minimum": torch.minimum,
    "maximum": torch.maximum, "eq": operator.eq, "ne": operator.ne,
    "lt": operator.lt, "gt": operator.gt, "le": operator.le, "ge": operator.ge,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "not": operator.invert, "neg": operator.neg, "where": torch.where,
    "clamp": torch.clamp, "to_float": lambda a: a.to(torch.float32),
    "abs": torch.abs, "reciprocal": torch.reciprocal,
}


def run_program(prog: Program, inputs: dict, device, rand=None) -> tuple:
    """Evaluate one step of `prog` with torch -> (outputs, cond). `inputs`
    maps each input key to a tensor (grids or 0-d). Constants are 0-d
    tensors on `device`, as the evaluator's literals are. `rand` = (the
    grid's global index, Loop.rand_salt, the iteration number) draws the
    "rand" ops with the evaluator's hash."""
    vals = []
    for op, operands, kind in prog.ops:
        if op == "in":
            vals.append(inputs[operands[0]])
            continue
        if op == "const":
            dtype = torch.bool if kind == "b" else torch.float32
            vals.append(torch.tensor(operands[0], dtype=dtype, device=device))
            continue
        if op == "rand":
            index, salt, loop_i = rand
            vals.append(rand_uniform(index, (salt + operands[0][1] * COUNTER) & M32, loop_i))
            continue
        args = [vals[o[1]] if o[0] == "v" else o[1] for o in operands]
        fn = _INTERP.get(op) or libm.FUNCTIONS.get(op) or getattr(torch, op)
        vals.append(fn(*args))

    def get(o):
        return vals[o[1]] if o[0] == "v" else o[1]

    return [get(o) for o in prog.outputs], get(prog.cond)


# ---------------------------------------------------------------------------
# CUDA emission
# ---------------------------------------------------------------------------

def _f32(v: float) -> str:
    """A float32 C++ literal, exact: hexadecimal, no decimal rounding; a
    negative one is parenthesised, so no operator can fuse with its sign."""
    v = float(np.float32(v))
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return f"({v.hex()}f)" if math.copysign(1.0, v) < 0 else f"{v.hex()}f"


_C_UNARY = {
    "neg": "-{0}", "not": "!{0}", "abs": "fabsf({0})", "floor": "floorf({0})",
    "ceil": "ceilf({0})", "round": "nearbyintf({0})", "sign": "mm_sign({0})",
    "sqrt": "sqrtf({0})", "exp": "expf({0})", "exp2": "exp2f({0})",
    "log": "logf({0})", "log2": "log2f({0})", "log10": "log10f({0})",
    "sin": "sinf({0})", "cos": "cosf({0})", "tan": "tanf({0})",
    "tanh": "tanhf({0})", "asin": "asinf({0})", "acos": "acosf({0})",
    "atan": "atanf({0})", "sinh": "sinhf({0})", "cosh": "coshf({0})",
    "asinh": "asinhf({0})", "acosh": "acoshf({0})", "atanh": "atanhf({0})",
    "reciprocal": "(1.0f / {0})", "to_float": "({0} ? 1.0f : 0.0f)",
}
_C_BINARY = {
    "add": "{0} + {1}", "sub": "{0} - {1}", "mul": "{0} * {1}",
    "remainder": "mm_remainder({0}, {1})", "fmod": "fmodf({0}, {1})",
    "atan2": "atan2f({0}, {1})", "minimum": "mm_minimum({0}, {1})",
    "maximum": "mm_maximum({0}, {1})", "eq": "{0} == {1}", "ne": "{0} != {1}",
    "lt": "{0} < {1}", "gt": "{0} > {1}", "le": "{0} <= {1}", "ge": "{0} >= {1}",
    "and": "{0} && {1}", "or": "{0} || {1}", "xor": "{0} != {1}",
}


def _c_expr(op: str, operands, name) -> str:
    """One op in C++ with PyTorch's CUDA semantics for its operand kinds:
    a Python-scalar divisor multiplies by its float32 reciprocal, and a
    Python-scalar numerator divides the reciprocal (Tensor.__rtruediv__),
    as PyTorch's CUDA kernels do; every other op is IEEE float32."""
    def ref(o):
        return name(o[1]) if o[0] == "v" else _f32(o[1])

    args = [ref(o) for o in operands]
    if op == "div":
        num, den = operands
        if den[0] == "s":
            return f"{args[0]} * {_f32(np.float32(1.0) / np.float32(den[1]))}"
        if num[0] == "s":
            return f"(1.0f / {args[1]}) * {args[0]}"
        return f"{args[0]} / {args[1]}"
    if op == "pow":
        if operands[1][0] == "s" or operands[0][0] == "s":
            raise GeneratorError("pow() with a Python-scalar operand")
        return f"powf({args[0]}, {args[1]})"
    if op == "where":
        return f"{args[0]} ? {args[1]} : {args[2]}"
    if op == "clamp":
        return f"mm_clamp({args[0]}, {args[1]}, {args[2]})"
    if op in _C_UNARY:
        return _C_UNARY[op].format(*args)
    if op in _C_BINARY:
        return _C_BINARY[op].format(*args)
    raise GeneratorError(f"op {op!r} has no CUDA spelling")


def emit_cuda(prog: Program, origin: str = "") -> str:
    """The kernel source of `prog` (csrc/while_loop.cu.tmpl filled in).
    Strided inputs are indexed in Program.grid_inputs order and scalars in
    Program.scalar_inputs order; carried values live in registers c<k>
    across iterations (trace() makes every carried slot an input)."""
    grids, scalars = prog.grid_inputs, prog.scalar_inputs
    scalar_slot = {k: n for n, k in enumerate(scalars)}
    grid_slot = {k: n for n, k in enumerate(grids)}

    names = {}
    loads, body = [], []
    if any(op == "rand" for op, _, _ in prog.ops):
        loads.append("  const unsigned int rand_idx = static_cast<unsigned int>(row0 + i) * "
                     "static_cast<unsigned int>(width) + static_cast<unsigned int>(col0 + j);")
        body.append("    const unsigned int loop_i = static_cast<unsigned int>(it_base + it + 1);")
    for i, (op, operands, kind) in enumerate(prog.ops):
        ctype = "bool" if kind == "b" else "float"
        if op == "in":
            key = operands[0]
            if key[0] == "carry":
                names[i] = f"c{key[1]}"
                loads.append(f"  float c{key[1]} = MM_IN({grid_slot[key]});")
            elif key[0] == "scalar":
                names[i] = f"v{i}"
                slot = scalar_slot[key]
                loads.append(f"  const float v{i} = a.s_dev ? a.s_dev[{slot}] : a.s_host[{slot}];")
            else:
                names[i] = f"v{i}"
                loads.append(f"  const float v{i} = MM_IN({grid_slot[key]});")
            continue
        names[i] = f"v{i}"
        if op == "const":
            value = operands[0]
            lit = ("true" if value else "false") if kind == "b" else _f32(value)
            loads.append(f"  const {ctype} v{i} = {lit};")
            continue
        if op == "rand":
            k_salt = (operands[0][1] * COUNTER) & M32
            body.append(f"    const float v{i} = mm_rand(rand_idx, rand_salt + 0x{k_salt:08x}u, loop_i);")
            continue
        expr = _c_expr(op, operands, names.__getitem__)
        body.append(f"    const {ctype} v{i} = {expr};")

    def ref(o):
        return names[o[1]] if o[0] == "v" else _f32(o[1])

    n_out = len(prog.outputs)
    body += [f"    const float n{k} = {ref(o)};" for k, o in enumerate(prog.outputs)]
    body.append(f"    active = {ref(prog.cond)};")
    body += [f"    c{k} = n{k};" for k in range(n_out)]
    stores = [f"  a.out[{k}][p] = c{k};" for k in range(n_out)]
    return string.Template(TEMPLATE.read_text()).substitute(
        origin=origin or "(unnamed)", n_ops=prog.n_compute_ops(),
        n_in=len(grids), n_out=n_out, n_scalars=len(scalars),
        n_in_alloc=max(1, len(grids)), n_out_alloc=max(1, n_out),
        n_scalars_alloc=max(1, len(scalars)),
        loads="\n".join(loads), body="\n".join(body), stores="\n".join(stores))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

#: generated source -> its loaded launcher, for this process
_LAUNCHERS: dict = {}
#: (id(node), spec) -> (node, Program, its text): a loop is traced once per
#: process, not once per render
_PREPARED: dict = {}
#: Program text -> (Program, its CUDA source or None until emitted): what the
#: op's implementations run, for this process's loops and for the loops of
#: the exported programs it loaded
_PROGRAMS: dict = {}


def _prepare(loop: Loop, n_flat: int):
    """The loop's Program and its text, traced on first use."""
    key = (id(loop.node), loop.spec)
    hit = _PREPARED.get(key)
    if hit is None or hit[0] is not loop.node:
        prog = trace(loop, n_flat)
        text = prog.to_text()
        _PROGRAMS.setdefault(text, [prog, None])
        hit = _PREPARED[key] = (loop.node, prog, text)
    return hit[1], hit[2]


def _program(text: str):
    """The Program of a text and its slot in _PROGRAMS."""
    entry = _PROGRAMS.get(text)
    if entry is None:
        entry = _PROGRAMS[text] = [Program.from_text(text), None]
    return entry


def build_program(text: str):
    """The launcher of a Program's text: its CUDA source emitted once, the
    library built by nvcc (or found on disk) and loaded once."""
    entry = _program(text)
    if entry[1] is None:
        entry[1] = emit_cuda(entry[0], entry[0].origin)
    return _launcher(entry[1])


def _launcher(source: str):
    fn = _LAUNCHERS.get(source)
    if fn is None:
        lib = build.generated_library(source)
        if lib.build_seconds > 0:
            while_loop.builds += 1
        fn = lib.cdll.mm_while_loop
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,  # ptrs, strides
                       ctypes.c_void_p, ctypes.c_void_p,  # scalars on the host, on the card
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, max_iters
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row0, col0, width
                       ctypes.c_uint32, ctypes.c_int,  # rand_salt, it_base
                       ctypes.c_void_p]  # stream
        fn.restype = ctypes.c_int
        _LAUNCHERS[source] = fn
    return fn


def _strides(t: torch.Tensor, shape, what: str):
    if t.dtype != torch.float32 and what != "mask":
        raise TypeError(f"loop {what} must be float32, got {t.dtype}")
    if t.dim() == 0:
        return (0, 0)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"loop {what} has shape {tuple(t.shape)}, not {tuple(shape)}")
    return t.stride()


torch.library.define(
    "mathmap::while_loop",
    "(str program, Tensor[] grids, Tensor mask, Tensor scalars, int max_iters, int unroll, "
    "int row0, int col0, int width, int rand_salt, int it_base) -> Tensor[]")


def _while_loop_cpu(program, grids, mask, scalars, max_iters, unroll, row0, col0, width,
                    rand_salt, it_base):
    """The plain version over the Program: the masked loop of
    while_loop_reference, each step one run_program under the mask."""
    prog = _program(program)[0]
    shape = tuple(mask.shape)
    values = dict(zip(prog.grid_inputs, grids))
    values.update({k: scalars[n] for n, k in enumerate(prog.scalar_inputs)})
    index = rand_index(shape, width, row0, col0, mask.device) if prog.draws else None

    def step(flat, m, loop_i):
        values.update({("carry", k): a for k, a in enumerate(flat)})
        outs, cond = run_program(prog, values, mask.device, rand=(index, rand_salt, loop_i))
        return tuple(torch.where(m, o, a) for o, a in zip(outs, flat)), m & cond

    flat0 = tuple(values[("carry", k)] for k in range(len(prog.outputs)))
    flat, _ = while_loop_reference(step, flat0, mask, max_iters, unroll, it_base)
    return [torch.broadcast_to(a, shape).clone(memory_format=torch.contiguous_format)
            for a in flat]


torch.library.impl("mathmap::while_loop", "CPU")(_while_loop_cpu)


def _while_loop_cuda(program, grids, mask, scalars, max_iters, unroll, row0, col0, width,
                     rand_salt, it_base):
    """Kernel B3: the Program's CUDA source, built once per distinct source
    (and found on disk after that), launched on the current stream."""
    prog = _program(program)[0]
    fn = build_program(program)
    dev = mask.device
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if scalars.dtype != torch.float32 or scalars.numel() != len(prog.scalar_inputs):
        raise ValueError(f"loop scalars must be {len(prog.scalar_inputs)} float32 values")
    h, w = (int(n) for n in mask.shape)
    for t in (*grids, mask):
        if t.device != dev:
            raise ValueError(f"loop input on {t.device}, expected {dev}")
    if scalars.device not in (dev, torch.device("cpu")):
        raise ValueError(f"loop scalars on {scalars.device}, expected {dev} or the CPU")
    strides = [s for k, t in zip(prog.grid_inputs, grids) for s in _strides(t, (h, w), str(k[0]))]
    strides += list(_strides(mask, (h, w), "mask"))
    outs = [torch.empty((h, w), dtype=torch.float32, device=dev) for _ in prog.outputs]
    if h * w == 0:
        return outs
    scalars = scalars.contiguous()
    on_host = scalars.device.type == "cpu"
    ptrs = (ctypes.c_void_p * (len(grids) + 1 + len(outs)))(
        *(t.data_ptr() for t in (*grids, mask, *outs)))
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, strides_c, scalars.data_ptr() if on_host else None,
                 None if on_host else scalars.data_ptr(), h, w,
                 min(int(max_iters), 2**31 - 1), row0, col0, width, rand_salt, it_base, stream)
    if err != 0:
        raise RuntimeError(
            f"while_loop kernel launch failed: cudaError {err} "
            f"({build.error_string(err)}) for the loop at {prog.origin}")
    while_loop.launches += 1
    return outs


torch.library.impl("mathmap::while_loop", "CUDA")(_while_loop_cuda)


def _while_loop_fake(program, grids, mask, scalars, max_iters, unroll, row0, col0, width,
                     rand_salt, it_base):
    return [mask.new_empty(mask.shape, dtype=torch.float32)
            for _ in _program(program)[0].outputs]


torch.library.register_fake("mathmap::while_loop")(_while_loop_fake)


def _scalars(ctx, keys, device) -> torch.Tensor:
    """The scalar inputs' values as one float32 tensor: on the host when
    every one is a float (the kernel takes them by value, no copy to the
    card), else on `device` (an exported program's `t` or `frame`)."""
    vals = [scalar_internal(ctx, k[1]) for k in keys]
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return torch.tensor(vals, dtype=torch.float32)
    return torch.stack([v.reshape(()) if isinstance(v, torch.Tensor)
                        else torch.tensor(v, dtype=torch.float32, device=device) for v in vals])


def while_loop(loop: Loop, flat0: tuple, mask0: torch.Tensor, max_iters: int) -> tuple:
    """Run `loop` from carry `flat0` ((H, W) float32 grids) and the first
    condition's mask `mask0` ((H, W) bool) until every pixel's condition
    fails or `max_iters` iterations -> the final carry.

    The loop is traced into its Program once, and the custom op
    `mathmap::while_loop` runs the Program's text, in the live render and
    in an exported program alike: on the CPU the masked loop over
    run_program (the plain version), on a CUDA device the loop's generated
    kernel, built once per distinct source and launched on the current
    stream without synchronising, or this raises. Iterations are numbered
    from loop.it_base + 1."""
    dev = mask0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no while-loop kernel for device {dev}")
    ctx = loop.ctx
    prog, text = _prepare(loop, len(flat0))
    values = {("carry", k): a for k, a in enumerate(flat0)}
    values[("x",)], values[("y",)] = loop.x, loop.y
    for name, tv in loop.deps:
        for j, a in enumerate(tv.arrays):
            values[("dep", name, j)] = a
    grids = [values[k] for k in prog.grid_inputs]
    scalars = _scalars(ctx, prog.scalar_inputs, dev)
    return tuple(torch.ops.mathmap.while_loop(
        text, grids, mask0, scalars, int(max_iters), int(loop.unroll), ctx.row_offset,
        ctx.col_offset, ctx.width, loop.rand_salt, loop.it_base))


#: kernel launches since the count was last set to 0 (CPU calls never count)
while_loop.launches = 0
#: generated kernels nvcc built in this process (a source found on disk or
#: already loaded is not counted)
while_loop.builds = 0
