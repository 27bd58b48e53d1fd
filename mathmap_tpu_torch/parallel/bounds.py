"""Static displacement-bound inference for halo-exchange tiling (a copy of
`mathmap_tpu/parallel/bounds.py`, which the port cannot import: it walks
the port's own AST, and `is_builtin` is the port's registry's, true for
the builtins the port has and those it has not ported yet alike, so the
bound never changes with what the port has ported).

The tiled renderer's correctness contract (halo.py) is that every image
sample stays within `halo` rows/cols of the sampling pixel. The reference
has no analog (it renders shared-memory, any pixel reachable via the tile
cache); for the TPU's distributed tiling the bound must come from the
filter itself. This module walks the filter AST with affine-interval
arithmetic — every scalar is tracked as

    sum_v coeff[v] * v  +  rest        (v in {x, y, r, a};
                                        coeff and rest are intervals)

so `origVal(xy + xy:[0, 2 * sin(x/3 + t)])` yields a y-displacement
interval of [-2, 2] exactly, and radial patterns `toXY(ra:[r + dr, a + da])`
bound the euclidean displacement by |dr| + R * |da|.

`infer_displacement_bound` returns (max_dy, max_dx) over all image samples
in the main filter body, or None when any sample is unbounded/unanalyzable
(user must size the halo manually). Used by render_tiled(halo="auto") and
by its debug contract check.
"""

from __future__ import annotations

import math

from ..lang import astnodes as A

INF = float("inf")


class Iv:
    """Closed interval [lo, hi] with conservative arithmetic."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi=None):
        self.lo = float(lo)
        self.hi = float(lo if hi is None else hi)

    def __add__(self, o):
        return Iv(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o):
        return Iv(self.lo - o.hi, self.hi - o.lo)

    def __mul__(self, o):
        vals = [self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi]
        vals = [0.0 if v != v else v for v in vals]  # inf*0 -> nan -> 0
        return Iv(min(vals), max(vals))

    def __neg__(self):
        return Iv(-self.hi, -self.lo)

    def union(self, o):
        return Iv(min(self.lo, o.lo), max(self.hi, o.hi))

    @property
    def mag(self):
        return max(abs(self.lo), abs(self.hi))

    def is_const(self):
        return self.lo == self.hi

    def __repr__(self):  # pragma: no cover - debug aid
        return f"[{self.lo}, {self.hi}]"


TOP = Iv(-INF, INF)
ZERO = Iv(0.0)
ONE = Iv(1.0)

BASIS = ("x", "y", "r", "a")


class Aff:
    """Affine form over the BASIS variables with an interval remainder."""

    __slots__ = ("coef", "rest")

    def __init__(self, coef=None, rest=ZERO):
        self.coef = dict(coef or {})
        self.rest = rest

    @staticmethod
    def const(iv):
        return Aff({}, iv)

    @staticmethod
    def var(name):
        return Aff({name: ONE}, ZERO)

    def __add__(self, o):
        coef = dict(self.coef)
        for k, v in o.coef.items():
            coef[k] = coef.get(k, ZERO) + v
        return Aff(coef, self.rest + o.rest)

    def __sub__(self, o):
        coef = dict(self.coef)
        for k, v in o.coef.items():
            coef[k] = coef.get(k, ZERO) - v
        return Aff(coef, self.rest - o.rest)

    def __neg__(self):
        return Aff({k: -v for k, v in self.coef.items()}, -self.rest)

    def scale(self, iv):
        # sound only when iv is a constant interval applied to affine terms
        return Aff({k: v * iv for k, v in self.coef.items()}, self.rest * iv)

    def is_const(self):
        return not any(v.lo != 0 or v.hi != 0 for v in self.coef.values())

    def interval(self, env) -> Iv:
        """Collapse to an interval given basis-variable ranges."""
        out = self.rest
        for k, v in self.coef.items():
            out = out + v * env[k]
        return out

    def union(self, o):
        keys = set(self.coef) | set(o.coef)
        return Aff(
            {k: self.coef.get(k, ZERO).union(o.coef.get(k, ZERO)) for k in keys},
            self.rest.union(o.rest),
        )


#: builtins with known output ranges (conservative; arg-independent)
_RANGE_FUNCS = {
    "sin": Iv(-1, 1), "cos": Iv(-1, 1), "atan": Iv(-math.pi / 2, math.pi / 2),
    "atan2": Iv(-math.pi, math.pi), "arg": Iv(-math.pi, math.pi),
    "noise": Iv(-1, 1), "sign": Iv(-1, 1), "rand01": Iv(0, 1),
}


class _Unbounded(Exception):
    pass


class BoundWalker:
    def __init__(self, filters, fdef, width, height, params=None):
        self.filters = filters
        self.width = width
        self.height = height
        cx, cy = width * 0.5, height * 0.5
        self.R = math.hypot(cx, cy)
        self.ranges = {
            "x": Iv(-cx, cx), "y": Iv(-cy, cy),
            "r": Iv(0, self.R), "a": Iv(0, 2 * math.pi),
        }
        self.env: dict[str, list[Aff]] = {}
        params = params or {}
        self.image_params = set()
        #: names that MAY alias an image param (q = in; q(xy) — review r5:
        #: the call fell through to the unknown-name path and the sample
        #: site was silently dropped, an UNSOUND (0,0) auto-halo bound).
        #: Monotone (a later non-image reassignment never removes): a call
        #: through a dead alias records a conservative extra sample.
        self.may_image: set[str] = set()
        #: names that MAY alias a user filter (calls are unbounded).
        self.may_filter: set[str] = set()
        #: curve/gradient params: calls are LUT lookups into [0,1], length
        #: 1 / 4 — bounded (must stay usable under the strict unknown-call
        #: rule below).
        self.lut_params: dict[str, int] = {}
        for p in fdef.params:
            if p.kind == "image":
                self.image_params.add(p.name)
            elif p.kind in ("curve", "gradient"):
                self.lut_params[p.name] = 1 if p.kind == "curve" else 4
            elif p.name in params and isinstance(params[p.name], (int, float)):
                self.env[p.name] = [Aff.const(Iv(float(params[p.name])))]
            elif p.kind in ("int", "float") and p.lo is not None and p.hi is not None:
                self.env[p.name] = [Aff.const(Iv(p.lo, p.hi))]
            elif p.kind == "bool":
                self.env[p.name] = [Aff.const(Iv(0, 1))]
        #: accumulated per-sample displacement bounds (dy, dx) as Iv.mag
        self.max_dy = 0.0
        self.max_dx = 0.0

    # ---- public -----------------------------------------------------
    def run(self, body) -> tuple[float, float] | None:
        try:
            self.stmt(body)
        except _Unbounded:
            return None
        return self.max_dy, self.max_dx

    # ---- statement walk ---------------------------------------------
    def stmt(self, node):
        if node is None:
            return
        if isinstance(node, A.Seq):
            for item in node.items:
                self.stmt(item)
        elif isinstance(node, A.SubAssign):
            self.expr(node.expr)
            self.expr(node.index)  # index may contain samples (review r3)
            if node.name in self.env:
                self.env[node.name] = [Aff.const(TOP)] * len(self.env[node.name])
        elif isinstance(node, A.While):
            # loop-carried values are unbounded statically; still walk the
            # body so samples inside loops are accounted (conservatively)
            for n in A.assigned_names(node.body) | A.assigned_names(node.cond):
                self.env[n] = [Aff.const(TOP)]
            self.stmt(node.cond)
            self.stmt(node.body)
        else:
            self.expr(node)

    # ---- expression evaluation ---------------------------------------
    def expr(self, node) -> list[Aff]:
        if node is None:
            return [Aff.const(TOP)]
        if isinstance(node, A.Num):
            return [Aff.const(Iv(node.value))]
        if isinstance(node, A.Var):
            return self.var(node.name)
        if isinstance(node, A.TupleLit):
            out = []
            for item in node.items:
                v = self.expr(item)
                out.append(v[0] if len(v) == 1 else Aff.const(TOP))
            return out
        if isinstance(node, A.Cast):
            return self.expr(node.expr)
        if isinstance(node, A.Subscript):
            base = self.expr(node.base)
            if isinstance(node.index, A.Num):
                i = int(node.index.value)
                if 0 <= i < len(base):
                    return [base[i]]
            self.expr(node.index)
            acc = base[0]
            for b in base[1:]:
                acc = acc.union(b)
            return [acc]
        if isinstance(node, A.Seq):
            out = [Aff.const(TOP)]
            for item in node.items:
                if isinstance(item, (A.SubAssign, A.While)):
                    self.stmt(item)
                    out = [Aff.const(TOP)]
                else:
                    out = self.expr(item)
            return out
        if isinstance(node, A.Assign):
            v = self.expr(node.expr)
            self.env[node.name] = v
            # image/filter alias tracking (monotone; also follows alias-of-
            # alias chains through a Var RHS, mirroring render.uses_sampling)
            rhs = node.expr
            if isinstance(rhs, A.Var):
                if rhs.name in self.image_params or rhs.name in self.may_image:
                    self.may_image.add(node.name)
                if rhs.name in self.filters or rhs.name in self.may_filter:
                    self.may_filter.add(node.name)
            elif not isinstance(rhs, (A.Num, A.TupleLit, A.BinOp, A.UnOp,
                                      A.Subscript, A.Cast)):
                # an If/Seq/Call RHS could select BETWEEN images — numeric-
                # only node kinds are safe; anything else makes the name a
                # possible image or filter (calls of it then go unbounded
                # via may_filter rather than silently bounded)
                self.may_filter.add(node.name)
            return v
        if isinstance(node, A.If):
            # evaluate branches on isolated envs and union both the branch
            # values and the assigned variables (phi), like the tracer
            self.expr(node.cond)
            saved = dict(self.env)
            a = self.expr(node.then)
            env_t = self.env
            self.env = dict(saved)
            if node.orelse is not None:
                b = self.expr(node.orelse)
            else:
                # the runtime yields ZERO when an else-less if is false
                # (tracer._zero_like) — using the then-value here let
                # affine cancellation hide real displacement (review r3)
                b = [Aff.const(Iv(0.0))] * len(a)
            env_e = self.env
            merged = {}
            for k in set(env_t) | set(env_e):
                va, vb = env_t.get(k), env_e.get(k)
                if va is None or vb is None or len(va) != len(vb):
                    merged[k] = [Aff.const(TOP)]
                else:
                    merged[k] = [p.union(q) for p, q in zip(va, vb)]
            self.env = merged
            if len(a) != len(b):
                return [Aff.const(TOP)]
            return [x.union(y) for x, y in zip(a, b)]
        if isinstance(node, A.BinOp):
            return self.binop(node)
        if isinstance(node, A.UnOp):
            v = self.expr(node.operand)
            if node.op == "-":
                return [-c for c in v]
            return [Aff.const(Iv(0, 1))]  # !v
        if isinstance(node, A.Call):
            return self.call(node)
        if isinstance(node, (A.While, A.SubAssign, A.Assign)):
            # statement in expression position (e.g. `1 + (while ... end)`):
            # route through stmt() so loop-body samples are recorded and
            # loop-assigned vars invalidate — the TOP fallback used to skip
            # the walk entirely (review r3)
            self.stmt(node)
            return [Aff.const(TOP)]
        return [Aff.const(TOP)]

    def var(self, name) -> list[Aff]:
        if name in self.env:
            return self.env[name]
        if name in BASIS:
            return [Aff.var(name)]
        cx, cy = self.width * 0.5, self.height * 0.5
        consts = {
            "X": cx, "Y": cy, "W": float(self.width), "H": float(self.height),
            "R": self.R, "pi": math.pi, "e": math.e,
        }
        if name in consts:
            return [Aff.const(Iv(consts[name]))]
        if name == "t":
            return [Aff.const(Iv(0, 1))]
        if name == "frame":
            return [Aff.const(Iv(0, INF))]
        if name == "xy":
            return [Aff.var("x"), Aff.var("y")]
        if name in ("WH", "wh"):
            return [Aff.const(Iv(self.width)), Aff.const(Iv(self.height))]
        return [Aff.const(TOP)]

    def binop(self, node: A.BinOp) -> list[Aff]:
        a = self.expr(node.left)
        b = self.expr(node.right)
        if len(a) == 1 and len(b) > 1:
            a = a * len(b)
        if len(b) == 1 and len(a) > 1:
            b = b * len(a)
        if len(a) != len(b):
            return [Aff.const(TOP)]
        op = node.op
        if op == "+":
            return [x + y for x, y in zip(a, b)]
        if op == "-":
            return [x - y for x, y in zip(a, b)]
        if op == "*":
            out = []
            for x, y in zip(a, b):
                if y.is_const():
                    out.append(x.scale(y.rest))
                elif x.is_const():
                    out.append(y.scale(x.rest))
                else:
                    out.append(Aff.const(
                        x.interval(self.ranges) * y.interval(self.ranges)))
            return out
        if op == "/":
            out = []
            for x, y in zip(a, b):
                yi = y.interval(self.ranges)
                if yi.lo > 0 or yi.hi < 0:
                    inv = Iv(1.0 / yi.hi, 1.0 / yi.lo)
                    out.append(x.scale(inv) if y.is_const() else
                               Aff.const(x.interval(self.ranges) * inv))
                else:
                    out.append(Aff.const(TOP))
            return out
        if op in ("==", "!=", "<", ">", "<=", ">=", "&&", "||", "xor"):
            return [Aff.const(Iv(0, 1))]
        if op == "%":
            yi = b[0].interval(self.ranges) if b else TOP
            if yi.lo > 0:
                return [Aff.const(Iv(0, yi.hi)) for _ in a]
            return [Aff.const(TOP) for _ in a]
        if op == "^":
            out = []
            for x, y in zip(a, b):
                xi, yi = x.interval(self.ranges), y.interval(self.ranges)
                if xi.lo >= 0 and xi.hi < INF and yi.hi < INF and yi.lo >= 0:
                    hi = max(xi.hi ** yi.hi, xi.hi ** yi.lo,
                             (xi.lo ** yi.lo if xi.lo > 0 else 0.0) or 0.0, 1.0)
                    out.append(Aff.const(Iv(0, hi)))
                else:
                    out.append(Aff.const(TOP))
            return out
        return [Aff.const(TOP) for _ in a]

    # ---- calls / sampling sites ---------------------------------------
    def call(self, node: A.Call) -> list[Aff]:
        func = node.func
        name = func.name if isinstance(func, A.Var) else None
        if name is None:
            # first-class application of a computed callee (e.g. an
            # applied-closure `f(p)(xy)`): the callee's body may sample
            # anywhere — walk subtrees for their own sample sites, then
            # give up (review r5: this silently returned TOP with no
            # sample recorded — an unsound auto-halo bound)
            self.expr(func)
            for a in node.args:
                self.expr(a)
            raise _Unbounded

        # image sampling sites (incl. local aliases q = in; q(xy))
        if name in self.may_image or (
                name in self.image_params and name not in self.env):
            if len(node.args) == 1:
                self.record_sample(self.expr(node.args[0]))
                return [Aff.const(Iv(0, 1))] * 4
            raise _Unbounded
        if name in ("origVal", "__canvas"):
            self.record_sample(self.expr(node.args[0]) if node.args else None)
            return [Aff.const(Iv(0, 1))] * 4
        if name == "origValImage":
            # origValImage(image, xy) — the same sampling-site list
            # render.uses_sampling keys on (review r3: was ignored, so
            # halo='auto' missed its displacement entirely)
            if len(node.args) == 2:
                self.expr(node.args[0])
                self.record_sample(self.expr(node.args[1]))
            else:
                raise _Unbounded
            return [Aff.const(Iv(0, 1))] * 4
        if name == "origValXY":
            if len(node.args) >= 2:
                ax = self.expr(node.args[0])
                ay = self.expr(node.args[1])
                if len(node.args) >= 3:
                    self.expr(node.args[2])  # frame arg may contain samples
                self.record_sample([ax[0], ay[0]])
            else:
                raise _Unbounded
            return [Aff.const(Iv(0, 1))] * 4
        if name in self.may_filter or (
                name in self.filters and name not in self.env):
            # filter-as-function (or an alias that may hold one): its body
            # may sample anywhere — unbounded (a future refinement could
            # inline-analyze it)
            for a in node.args:
                self.expr(a)
            raise _Unbounded
        if name in ("gaussian_blur", "gaussian-blur", "gaussianBlur"):
            # native blur: its FOOTPRINT (conv radius ~3*stddev) is a halo
            # requirement this walker does not model on image values —
            # unbounded rather than silently footprint-free (review r5)
            for a in node.args:
                self.expr(a)
            raise _Unbounded
        if name in self.lut_params:
            for a in node.args:
                self.expr(a)
            return [Aff.const(Iv(0, 1))] * self.lut_params[name]

        args = [self.expr(a) for a in node.args]

        # radial pattern: toXY(ra:[r_expr, a_expr]) — euclidean displacement
        # bounded by |dr| + R*|da|
        if name == "toXY" and len(args) == 1 and len(args[0]) == 2:
            re_, ae = args[0]
            dr = (re_ - Aff.var("r")).interval(self.ranges)
            da = (ae - Aff.var("a")).interval(self.ranges)
            if dr.mag < INF and da.mag < INF:
                b = Iv(-(dr.mag + self.R * min(da.mag, 2 * math.pi)),
                       dr.mag + self.R * min(da.mag, 2 * math.pi))
                return [Aff.var("x") + Aff.const(b), Aff.var("y") + Aff.const(b)]
            return [Aff.const(TOP), Aff.const(TOP)]
        if name == "toRA" and len(args) == 1 and len(args[0]) == 2:
            return [Aff.const(Iv(0, self.R * 2)), Aff.const(Iv(0, 2 * math.pi))]

        if name in _RANGE_FUNCS:
            return [Aff.const(_RANGE_FUNCS[name])]
        if name == "rand" and len(args) == 2:
            lo = args[0][0].interval(self.ranges)
            hi = args[1][0].interval(self.ranges)
            return [Aff.const(Iv(lo.lo, hi.hi))]
        if name == "abs" and len(args) == 1 and len(args[0]) == 1:
            iv = args[0][0].interval(self.ranges)
            return [Aff.const(Iv(0.0, iv.mag))]
        if name in ("min", "max") and len(args) == 2:
            ivs = [c.interval(self.ranges) for a in args for c in a]
            lo = min(i.lo for i in ivs)
            hi = max(i.hi for i in ivs)
            return [Aff.const(Iv(lo, hi))]
        if name == "clamp" and len(args) == 3:
            # runtime clamp broadcasts tuple lo/hi ELEMENTWISE — component
            # i clamps to (lo_i, hi_i), not (lo_0, hi_0) (review r3)
            out = []
            for i in range(len(args[0])):
                lo = args[1][min(i, len(args[1]) - 1)].interval(self.ranges)
                hi = args[2][min(i, len(args[2]) - 1)].interval(self.ranges)
                out.append(Aff.const(Iv(lo.lo, hi.hi)))
            return out
        if name in ("floor", "ceil", "round"):
            return [c + Aff.const(Iv(-1, 1)) for c in args[0]] if args else [Aff.const(TOP)]
        if name in ("sqrt",) and args and len(args[0]) == 1:
            iv = args[0][0].interval(self.ranges)
            if iv.hi < INF:
                return [Aff.const(Iv(0, math.sqrt(max(iv.hi, 0.0))))]
            return [Aff.const(TOP)]
        if name in ("grayColor", "rgbColor"):
            return [Aff.const(Iv(0, 1))] * 4
        if name == "rgbaColor":
            return [Aff.const(Iv(0, 1))] * 4
        # registered builtins never sample images (the sampling ones are
        # handled above): args were evaluated, top value is sound. A call
        # of an UNCLASSIFIED name (a local variable holding who-knows-what
        # being applied) is not — it may be an image/closure obtained some
        # way the alias tracking missed; go unbounded (review r5)
        from ..ops.registry import is_builtin

        if not is_builtin(name):
            raise _Unbounded
        return [Aff.const(TOP)]

    def record_sample(self, arg: list[Aff] | None):
        if arg is None:
            return  # origVal() with no arg = xy (identity)
        if len(arg) != 2:
            raise _Unbounded
        dx = (arg[0] - Aff.var("x")).interval(self.ranges)
        dy = (arg[1] - Aff.var("y")).interval(self.ranges)
        if dx.mag == INF or dy.mag == INF:
            raise _Unbounded
        self.max_dx = max(self.max_dx, dx.mag)
        self.max_dy = max(self.max_dy, dy.mag)


def infer_displacement_bound(filters, fdef, width: int, height: int,
                             params: dict | None = None):
    """(max |dy|, max |dx|) over every image-sampling site of `fdef`, or
    None when any site is statically unbounded/unanalyzable."""
    return BoundWalker(filters, fdef, width, height, params).run(fdef.body)
