"""Kernel B3, the per-pixel `while` loop: the op list, the CUDA generator,
the wrapper with its launch count, and the plain version.

The kernel replaces the JAX package's in-VMEM while engine
`mathmap_tpu/pallas_kernels/while_kernel.py::launch`. A loop's body differs
per filter, so its kernel is generated: the evaluator's own `step` closure
runs ONCE on symbolic per-pixel scalars (`Sym`; runtime/tracer.py::trace
drives it), whose `__torch_function__` and arithmetic dunders record every
torch op the builtins reach into an SSA list (`Program`). `emit_cuda`
prints that list as C++, one line per op, into csrc/while_loop.cu.tmpl;
kernels/build.py compiles it with nvcc (`--fmad=false`) into a library of
its own, cached per process and on disk by a hash of the source.
`run_program` interprets the same list with torch, so the CPU tests hold
the op list against the eager loop and only the C spelling of each op is
left to the card. Which loops come here, and how the evaluator hands one
over, is the front end's (runtime/loops.py); this module knows nothing of
the language or the evaluator.

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
evaluator's closure (`while_loop_reference` with the closure as its step).

What bounds the kernel: operations (pixels x iterations x ops per
iteration), then the carried and dependency bytes read and written once,
and warp divergence (a warp runs until its slowest pixel exits).
"""

from __future__ import annotations

import ctypes
import json
import math
import operator
import string
from pathlib import Path

import numpy as np
import torch

from ..ops import libm
from ..ops.rand import COUNTER, M32, rand_index, rand_uniform
from ..utils.trace import count, span
from . import build

#: a wait on the device while a step is traced: a one-element tensor read
#: back to become a constant of the Program (Program.operand)
_LOOP = span("mm.sync.loop")
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

TEMPLATE = Path(__file__).resolve().parent.parent / "csrc" / "while_loop.cu.tmpl"


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def any_active(mask) -> bool:
    """Whether any pixel of the mask still loops, read on the host."""
    return bool(mask.any())


def while_loop_reference(step, flat0, mask0, max_iters: int, unroll: int, it_base: int = 0,
                         check=any_active):
    """The eager masked loop -> (final flat carry, steps run): `unroll`
    masked steps per `check(mask)`, none past `max_iters`, numbered from
    it_base + 1. A step past a pixel's exit leaves it as it was, so the
    count of checks changes no value."""
    flat, mask, i = flat0, mask0, 0
    while i < max_iters and check(mask):
        for _ in range(min(unroll, max_iters - i)):
            flat, mask = step(flat, mask, it_base + i + 1)
            i += 1
    return flat, i


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
            with _LOOP:
                value = v.reshape(()).item()
            return ("v", self.const(value).index)
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
    across iterations (runtime/tracer.py::trace makes every carried slot an
    input)."""
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
#: Program text -> (Program, its CUDA source or None until emitted): what the
#: op's implementations run, for this process's loops and for the loops of
#: the exported programs it loaded
_PROGRAMS: dict = {}


def register(prog: Program) -> str:
    """The Program's text, the op's first argument, with the Program kept
    for the op's implementations (they need not read the text back)."""
    text = prog.to_text()
    _PROGRAMS.setdefault(text, [prog, None])
    return text


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
        with span("mm.build"):
            entry[1] = emit_cuda(entry[0], entry[0].origin)
    return _launcher(entry[1])


#: the C interface's parameters, csrc/while_loop.cu.tmpl::mm_while_loop
ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p,  # ptrs, strides
    ctypes.c_void_p, ctypes.c_void_p,  # scalars on the host, on the card
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, max_iters
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row0, col0, width
    ctypes.c_uint32, ctypes.c_int,  # rand_salt, it_base
    ctypes.c_void_p,  # stream
)


def _launcher(source: str):
    fn = _LAUNCHERS.get(source)
    if fn is None:
        fn = _LAUNCHERS[source] = build.function(
            "mm_while_loop", ARGTYPES, build.generated_library(source))
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
    build.raise_for(err, "while_loop", f" for the loop at {prog.origin}")
    count("launch.while_loop")
    return outs


torch.library.impl("mathmap::while_loop", "CUDA")(_while_loop_cuda)


def _while_loop_fake(program, grids, mask, scalars, max_iters, unroll, row0, col0, width,
                     rand_salt, it_base):
    return [mask.new_empty(mask.shape, dtype=torch.float32)
            for _ in _program(program)[0].outputs]


torch.library.register_fake("mathmap::while_loop")(_while_loop_fake)
