"""Composer/designer: a node graph of filters compiled to one MathMap source
(a copy of `mathmap_tpu/designer/graph.py`; `compile` goes through this
package's `api.compile_source`).

Reference: `designer/` — node-graph editor where nodes are filters and edges
are image flow; a graph "compiles" by generating a single composite MathMap
filter source; composition has NO runtime representation (SURVEY.md §2.1
composer row, §3.4 call stack [unverified — mount empty, SURVEY.md §0]).
The GTK canvas is replaced by a programmatic graph API; `.mmc` files use the
s-expression serialization (designer/sexpr.py).

.mmc schema (this rebuild's serialization [unverified vs reference]):

    (composer
      (node "id" "filter_name"
        (param "name" <number> | (ref "other_id") | (input <k>)) ...)
      (output "id"))
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.errors import MMNameError, MMRuntimeError
from . import sexpr
from .sexpr import Symbol


@dataclass
class Ref:
    node_id: str


@dataclass
class InputRef:
    index: int


@dataclass
class Node:
    node_id: str
    filter_name: str
    params: dict = field(default_factory=dict)  # name -> float | Ref | InputRef


@dataclass
class DesignerGraph:
    """A DAG of filter nodes. `db` (ExpressionDB) supplies filter sources."""

    db: object = None
    nodes: dict = field(default_factory=dict)
    output: str | None = None
    _counter: int = 0

    # -- construction -------------------------------------------------------
    def add(self, filter_name: str, node_id: str | None = None, **params) -> str:
        if node_id is None:
            self._counter += 1
            node_id = f"n{self._counter}"
        if node_id in self.nodes:
            raise MMRuntimeError(f"duplicate node id {node_id!r}")
        norm = {}
        for k, v in params.items():
            if isinstance(v, (Ref, InputRef)):
                norm[k] = v
            elif isinstance(v, str):
                norm[k] = Ref(v)
            else:
                norm[k] = float(v)
        self.nodes[node_id] = Node(node_id, filter_name, norm)
        self.output = node_id  # last added is the default output
        return node_id

    def connect(self, src_id: str, dst_id: str, param: str) -> None:
        self.nodes[dst_id].params[param] = Ref(src_id)

    # -- codegen ------------------------------------------------------------
    def _topo(self) -> list:
        order, seen, visiting = [], set(), set()

        def visit(nid):
            if nid in seen:
                return
            if nid in visiting:
                raise MMRuntimeError(f"composer graph has a cycle through {nid!r}")
            visiting.add(nid)
            for v in self.nodes[nid].params.values():
                if isinstance(v, Ref):
                    if v.node_id not in self.nodes:
                        raise MMNameError(f"edge references unknown node {v.node_id!r}")
                    visit(v.node_id)
            visiting.discard(nid)
            seen.add(nid)
            order.append(nid)

        if self.output is None:
            raise MMRuntimeError("composer graph has no output node")
        if self.output not in self.nodes:
            raise MMNameError(
                f"composer output references unknown node {self.output!r}")
        visit(self.output)
        return order

    def _filter_def(self, name: str):
        if self.db is None:
            raise MMRuntimeError("graph has no filter database attached")
        if name not in self.db.entries:
            raise MMNameError(f"composer references unknown filter {name!r}")
        return self.db.entries[name]

    def to_source(self, name: str = "composed") -> str:
        """Generate the composite .mm source: every referenced filter's
        definition followed by a main filter wiring them together
        (topological walk — SURVEY §3.4)."""
        order = self._topo()
        # collect image inputs used
        n_inputs = 0
        for nid in order:
            for v in self.nodes[nid].params.values():
                if isinstance(v, InputRef):
                    n_inputs = max(n_inputs, v.index + 1)
        defs, included = [], set()
        for nid in order:
            fname = self.nodes[nid].filter_name
            if fname not in included:
                entry = self._filter_def(fname)
                defs.append(entry.source.rstrip())
                included.add(fname)
        lines = []
        args = ", ".join(f"image in{k}" for k in range(max(n_inputs, 1)))
        lines.append(f"filter {name} ({args})")
        for nid in order:
            node = self.nodes[nid]
            entry = self._filter_def(node.filter_name)
            declared = {p.name for p in entry.fdef.params}
            unknown = sorted(set(node.params) - declared)
            if unknown:
                # a typo'd param name silently rendered with the default
                # value (review r5) — name the node and what IS declared
                raise MMNameError(
                    f"node {nid!r}: filter {node.filter_name!r} has no "
                    f"parameter {unknown[0]!r} (declared: "
                    f"{', '.join(sorted(declared)) or 'none'})")
            call_args = []
            for p in entry.fdef.params:
                v = node.params.get(p.name)
                if v is None:
                    if p.kind == "image":
                        v = InputRef(0)
                    else:
                        v = Symbol("__default__")  # placeholder, resolved below
                if isinstance(v, Ref):
                    call_args.append(f"img_{v.node_id}")
                elif isinstance(v, InputRef):
                    call_args.append(f"in{v.index}")
                elif isinstance(v, Symbol):
                    call_args.append(v)
                else:
                    call_args.append(repr(v))
            # trailing defaults bind at trace time; a default in the MIDDLE
            # must be spelled out to keep positional binding aligned
            while call_args and isinstance(call_args[-1], Symbol):
                call_args.pop()
            for i, (arg, p) in enumerate(zip(call_args, entry.fdef.params)):
                if isinstance(arg, Symbol):
                    if p.kind in ("int", "float", "bool"):
                        d = p.default if p.default is not None else (p.lo or 0.0)
                        call_args[i] = repr(float(d))
                    else:
                        raise MMRuntimeError(
                            f"node {nid!r}: parameter {p.name!r} ({p.kind}) must "
                            f"be set — it precedes an explicitly-set parameter"
                        )
            lines.append(f"  img_{nid} = {node.filter_name}({', '.join(call_args)});")
        lines.append(f"  img_{self.output}(xy)")
        lines.append("end")
        return "\n\n".join(defs + ["\n".join(lines)])

    def compile(self, name: str = "composed"):
        from ..api import compile_source

        return compile_source(self.to_source(name))

    # -- serialization --------------------------------------------------------
    def to_mmc(self) -> str:
        forms = [Symbol("composer")]
        for nid, node in self.nodes.items():
            nf = [Symbol("node"), nid, node.filter_name]
            for k, v in node.params.items():
                if isinstance(v, Ref):
                    nf.append([Symbol("param"), k, [Symbol("ref"), v.node_id]])
                elif isinstance(v, InputRef):
                    nf.append([Symbol("param"), k, [Symbol("input"), float(v.index)]])
                else:
                    nf.append([Symbol("param"), k, float(v)])
            forms.append(nf)
        forms.append([Symbol("output"), self.output or ""])
        return sexpr.dumps(forms) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_mmc())


def from_mmc(text: str, db=None) -> DesignerGraph:
    forms = sexpr.loads(text)
    if not forms or not forms[0] or forms[0][0] != Symbol("composer"):
        raise MMRuntimeError("not a composer file (expected (composer ...))")
    graph = DesignerGraph(db=db)
    for form in forms[0][1:]:
        head = form[0]
        if head == Symbol("node"):
            nid, fname = str(form[1]), str(form[2])
            params = {}
            for pf in form[3:]:
                if pf[0] != Symbol("param"):
                    raise MMRuntimeError(f"bad node entry {pf!r}")
                key, val = str(pf[1]), pf[2]
                if isinstance(val, list) and val and val[0] == Symbol("ref"):
                    params[key] = Ref(str(val[1]))
                elif isinstance(val, list) and val and val[0] == Symbol("input"):
                    params[key] = InputRef(int(val[1]))
                else:
                    try:
                        params[key] = float(val)
                    except (TypeError, ValueError):
                        raise MMRuntimeError(
                            f"composer param {key!r} of node {nid!r}: "
                            f"expected a number, (ref ...) or (input ...), "
                            f"got {val!r}") from None
            graph.nodes[nid] = Node(nid, fname, params)
        elif head == Symbol("output"):
            graph.output = str(form[1]) or None
    # restore the id counter PAST the loaded ids so add() after a load
    # doesn't collide (review r3: load_mmc + add() raised duplicate-id)
    import re as _re

    for nid in graph.nodes:
        m = _re.fullmatch(r"n(\d+)", nid)
        if m:
            graph._counter = max(graph._counter, int(m.group(1)))
    return graph


def load_mmc(path: str, db=None) -> DesignerGraph:
    with open(path) as f:
        return from_mmc(f.read(), db=db)


def from_pipeline(spec: str, db) -> DesignerGraph:
    """Build a linear chain graph from pipe syntax:

        "grayscale | twirl angle=4.5 | vignette strength=2"

    Each stage is `filter_name [param=value ...]`; the first stage's image
    input is invocation input 0, later stages consume the previous stage.
    """
    graph = DesignerGraph(db=db)
    prev = None
    for stage in spec.split("|"):
        parts = stage.split()
        if not parts:
            raise MMRuntimeError("empty stage in pipeline spec")
        name, kwargs = parts[0], {}
        for item in parts[1:]:
            if "=" not in item:
                raise MMRuntimeError(f"pipeline param must be name=value, got {item!r}")
            k, v = item.split("=", 1)
            kwargs[k] = float(v)
        entry = graph._filter_def(name) if db else None  # validates name early
        img_params = [p.name for p in entry.fdef.params if p.kind == "image"] if entry else ["in"]
        if img_params:
            kwargs[img_params[0]] = prev if prev is not None else InputRef(0)
        elif prev is not None:
            # a generative stage mid-pipeline has nowhere to consume the
            # previous stage — silently dropping everything upstream
            # rendered the wrong image (review r3)
            raise MMRuntimeError(
                f"pipeline stage {name!r} takes no image input, so the "
                f"previous stages' output would be discarded — a "
                f"generative filter can only start a chain")
        prev = Ref(graph.add(name, **kwargs))
    return graph
