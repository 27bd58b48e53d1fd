"""AST node definitions for the MathMap language.

Mirrors the capability surface of the reference's `exprtree` node kinds
(`parser.y` / `exprtree.c` [unverified — mount empty, SURVEY.md §0]):
int/float/tuple const, variable, internal, userval ref, function call,
operator (sugar for calls), assignment, sub-assignment (`v[i]=`), sequence
`;`, if/while/do-while, filter definition with typed arg list.

The TPU rebuild keeps the AST as the sole IR: SSA construction and the
optimization passes of the reference's `compiler.c` are not rebuilt because
XLA performs folding/CSE/DCE on the traced program (SURVEY.md §7 design
decision: whole-grid tracing replaces per-pixel codegen).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.errors import Span


@dataclass(frozen=True)
class Node:
    span: Span = field(default_factory=Span, compare=False)


@dataclass(frozen=True)
class Num(Node):
    value: float = 0.0


@dataclass(frozen=True)
class Var(Node):
    name: str = ""


@dataclass(frozen=True)
class TupleLit(Node):
    items: tuple = ()


@dataclass(frozen=True)
class Cast(Node):
    """Retagging `tag:expr` (the `:` operator of tags.c)."""

    tag: str = ""
    expr: Node | None = None


@dataclass(frozen=True)
class Subscript(Node):
    base: Node | None = None
    index: Node | None = None


@dataclass(frozen=True)
class Call(Node):
    """Function/builtin call, or application of an image/curve/gradient value.

    `func` is an expression; when it is a plain Var naming a builtin or a
    filter the call binds statically (overload.c behavior), otherwise the
    callee is evaluated to a first-class image value and applied (SURVEY §3.5).
    """

    func: Node | None = None
    args: tuple = ()


@dataclass(frozen=True)
class BinOp(Node):
    op: str = ""
    left: Node | None = None
    right: Node | None = None


@dataclass(frozen=True)
class UnOp(Node):
    op: str = ""
    operand: Node | None = None


@dataclass(frozen=True)
class Assign(Node):
    name: str = ""
    expr: Node | None = None


@dataclass(frozen=True)
class SubAssign(Node):
    """Sub-assignment `v[i] = e` — functional update on the tuple."""

    name: str = ""
    index: Node | None = None
    expr: Node | None = None


@dataclass(frozen=True)
class Seq(Node):
    items: tuple = ()


@dataclass(frozen=True)
class If(Node):
    cond: Node | None = None
    then: Node | None = None
    orelse: Node | None = None


@dataclass(frozen=True)
class While(Node):
    """`while c do body end` (post=False) or `do body while c end` (post=True)."""

    cond: Node | None = None
    body: Node | None = None
    post: bool = False


#: Userval kinds supported in filter signatures (userval.c/h per SURVEY §2.1).
USERVAL_KINDS = ("int", "float", "bool", "color", "curve", "gradient", "image")


@dataclass(frozen=True)
class Param(Node):
    kind: str = "float"  # one of USERVAL_KINDS
    name: str = ""
    lo: float | None = None
    hi: float | None = None
    default: object | None = None


@dataclass(frozen=True)
class FilterDef(Node):
    name: str = ""
    params: tuple = ()  # tuple[Param]
    body: Node | None = None
    options: tuple = ()  # filter option annotations (e.g. "pixel"), kept verbatim


@dataclass(frozen=True)
class Program(Node):
    filters: tuple = ()  # tuple[FilterDef]; last one is the main filter


def walk(node):
    """Yield every node in the subtree (pre-order)."""
    if node is None:
        return
    yield node
    if isinstance(node, TupleLit):
        for item in node.items:
            yield from walk(item)
    elif isinstance(node, Cast):
        yield from walk(node.expr)
    elif isinstance(node, Subscript):
        yield from walk(node.base)
        yield from walk(node.index)
    elif isinstance(node, Call):
        yield from walk(node.func)
        for a in node.args:
            yield from walk(a)
    elif isinstance(node, BinOp):
        yield from walk(node.left)
        yield from walk(node.right)
    elif isinstance(node, UnOp):
        yield from walk(node.operand)
    elif isinstance(node, Assign):
        yield from walk(node.expr)
    elif isinstance(node, SubAssign):
        yield from walk(node.index)
        yield from walk(node.expr)
    elif isinstance(node, Seq):
        for item in node.items:
            yield from walk(item)
    elif isinstance(node, If):
        yield from walk(node.cond)
        yield from walk(node.then)
        yield from walk(node.orelse)
    elif isinstance(node, While):
        yield from walk(node.cond)
        yield from walk(node.body)
    elif isinstance(node, FilterDef):
        yield from walk(node.body)
    elif isinstance(node, Program):
        for f in node.filters:
            yield from walk(f)


def assigned_names(node) -> set:
    """Names assigned anywhere in the subtree (for while-loop carry discovery)."""
    out = set()
    for sub in walk(node):
        if isinstance(sub, (Assign, SubAssign)):
            out.add(sub.name)
    return out
