"""The while loop's front end: which loops kernel B3 takes, what such a
loop reads, and how the evaluator's loop reaches B3's op or torch's
`while_loop` op.

runtime/tracer.py::_eval_While decides a loop's route. For a loop that
`eligible` admits and whose values `dependencies` can pass, it builds a
`Loop` (its step closure, the values it reads and where it came from) and
hands it to `while_loop` here: the loop is traced into its Program once
per process (`_prepare`, through `Loop.trace`, the tracer's symbolic
evaluator), and the custom op `mathmap::while_loop` (kernels/while_loop.py)
runs the Program's text, on the CPU its plain version and on the card the
generated kernel. A loop B3 does not take runs as the eager masked loop,
whose `any()` check reads the mask on the host; a program traced by
torch.export cannot do that, so there `while_loop_exported` writes it as
torch's `while_loop` op with the same gated steps.

Before a loop runs, its probe evaluates the condition and the body once
to learn each carried name's length and tag (tracer.py::_eval_While).
That outcome follows from the loop's text and from what `probe_key`
reads, so each loop keeps a memo of it (`probe_outcome`): a later frame
with the same key runs no probe and adds 1 to the counter `probe.cached`.

Imports point one way: runtime/tracer.py imports this module, which
imports the kernel layer and the value model, and nothing of the
evaluator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.compiler as _compiler

from ..kernels.while_loop import SAFE_CALLS, register
from ..lang import astnodes as A
from ..ops.rand import draw_salt
from ..utils.constants import exact
from ..utils.trace import count, span
from .value import ClosureImage, InputImage, TiledInput

#: a wait of the loop's wrapper on the device
_LOOP = span("mm.sync.loop")

#: outcomes kept before the memo is emptied: far above the loops and keys
#: of the filters one process renders (the service and the designer
#: compile programs without end)
PROBE_ENTRIES = 4096

#: (id(node), probe_key) -> (node, outcome): the loops' memo of their
#: probes; the entry holds the node, so its id names no other loop
#: meanwhile
_PROBES: dict = {}

#: internals that are kernel scalar arguments rather than baked literals
SCALAR_INTERNALS = ("t", "frame", "X", "Y", "W", "H", "R")


def scalar_internal(ctx, name: str):
    """The value the evaluator's literal of a scalar internal holds: a
    float, or for `t` and `frame` the 0-d tensor of an exported program's
    input (generators/artifact.py)."""
    return {"t": ctx.t, "frame": ctx.frame, "X": ctx.width * 0.5,
            "Y": ctx.height * 0.5, "W": float(ctx.width), "H": float(ctx.height),
            "R": ((ctx.width * 0.5) ** 2 + (ctx.height * 0.5) ** 2) ** 0.5}[name]


def eligible(node: A.While, env: dict, filters: dict) -> bool:
    """Whether a loop can run as a generated kernel, decided from its AST:
    every call is a SAFE_CALLS builtin that no env value or user filter
    shadows, and no loop is nested in it."""
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


def dependencies(node: A.While, init_env: dict, carried, shape) -> list | None:
    """The non-carried env values the loop reads, as (name, TupleValue) in
    name order; None when one is opaque or not a float32 scalar or `shape`
    grid, which makes the loop ineligible."""
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


def _checked(img) -> bool:
    """Whether sampling `img` reports to the tiled renderer's halo check."""
    return isinstance(img, TiledInput) and img.violation_hook is not None


def _image_key(img) -> tuple:
    """What a probe can learn of an input image: its kind, and whether it
    is an animated stack."""
    return type(img), img.pixels.dim()


def _value_key(v) -> tuple | None:
    """What a probe can learn of an env value: its tag and length and the
    exact bits of its host constants, or its payload's type (a closure's
    filter and arguments). None for a value whose samples the halo check
    measures."""
    p = v.payload
    if p is None:
        return v.tag, len(v.arrays), None if v.const is None else tuple(map(exact, v.const))
    if isinstance(p, InputImage):
        return None if _checked(p) else (v.tag, _image_key(p))
    if isinstance(p, ClosureImage):
        args = tuple(_value_key(a) for a in p.args)
        return None if None in args else (v.tag, ClosureImage, p.filter_def.name, args)
    return v.tag, type(p)


def probe_key(env: dict, ctx, salt_extra) -> tuple | None:
    """Everything a loop's probe outcome depends on besides the loop's
    text: each env value's `_value_key`, the frame's width and height
    (the constants of X, Y, W, H, R and WH), the render options, whether
    the loop runs in another loop's step, the dtype, the inlining depth
    and the inputs' kinds. Tensors, `t`, `frame` and passed params carry
    no constant, so a frame of the same filter has the same key. None
    bypasses the memo: while torch compiles or exports, and where a sample
    could reach the halo check, which measures the probe's taps (at loop
    depth 0) on every frame."""
    if _compiler._is_compiling_flag or any(_checked(img) for img in ctx.inputs):
        return None
    values = []
    for name, v in env.items():
        k = _value_key(v)
        if k is None:
            return None
        values.append((name, k))
    return (tuple(values), ctx.width, ctx.height, ctx.opts, salt_extra is None, ctx.dtype,
            ctx.inline_depth, tuple(map(_image_key, ctx.inputs)))


def probe_outcome(node: A.While, key: tuple | None, probe: Callable) -> dict:
    """The loop's probe outcome, {carried name: (length, tag)}: the one its
    memo keeps under `key`, a hit counted in `probe.cached`, else what
    `probe()` returns, kept. With key None `probe()` runs and nothing is
    kept; a probe that raises keeps nothing. The outcome is shared: never
    write into it."""
    if key is None:
        return probe()
    entry = _PROBES.get((id(node), key))
    if entry is not None:
        count("probe.cached")
        return entry[1]
    got = probe()
    if len(_PROBES) >= PROBE_ENTRIES:
        _PROBES.clear()
    _PROBES[id(node), key] = node, got
    return got


def probe_memo(node: A.While) -> dict:
    """The loop's entries in the memo: {probe_key: outcome}."""
    return {key: got for (_, key), (n, got) in list(_PROBES.items()) if n is node}


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
    #: trace(loop, n_flat) -> its Program: `step` run once on symbolic
    #: per-pixel scalars (runtime/tracer.py::trace)
    trace: Callable
    deps: list  # [(name, TupleValue)], dependencies()
    x: torch.Tensor
    y: torch.Tensor
    ctx: Any  # RenderContext
    unroll: int  # masked steps per convergence check (plain version)
    node: A.While
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


#: (id(node), spec) -> (node, Program, its text): a loop is traced once per
#: process, not once per render
_PREPARED: dict = {}


def _prepare(loop: Loop, n_flat: int):
    """The loop's Program and its text, traced on first use."""
    key = (id(loop.node), loop.spec)
    hit = _PREPARED.get(key)
    if hit is None or hit[0] is not loop.node:
        prog = loop.trace(loop, n_flat)
        hit = _PREPARED[key] = (loop.node, prog, register(prog))
    return hit[1], hit[2]


def _scalars(ctx, keys, device) -> torch.Tensor:
    """The scalar inputs' values as one float32 tensor: on the host when
    every one is a float (the kernel takes them by value, no copy to the
    card), else on `device` (an exported program's `t` or `frame`)."""
    vals = [scalar_internal(ctx, k[1]) for k in keys]
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return torch.tensor(vals, dtype=torch.float32)
    return torch.stack([v.reshape(()) if isinstance(v, torch.Tensor)
                        else _LOOP.tensor(v, torch.float32, device) for v in vals])


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


def while_loop_exported(step, flat0, mask0, max_iters: int, unroll: int, it_base: int = 0):
    """The masked loop of kernels/while_loop.py::while_loop_reference inside
    a program that torch.export traces -> the final flat carry. Its `any()`
    check cannot run on the host there, so the loop is torch's while loop
    (the higher-order op `while_loop`, which the exported program keeps and
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
