"""Each builtin the port has, on seeded inputs, against the reference builtin
on the NumPy backend (an oracle Evaluator). Both sides compute elementwise
float32, so the tolerance is rtol=1e-5, atol=1e-6."""

import zlib

import numpy as np
import pytest
import torch

import mathmap_tpu.ops  # noqa: F401  — populate the reference table
import mathmap_tpu_torch.ops  # noqa: F401  — populate the port's table
from mathmap_tpu.ops import registry as RR
from mathmap_tpu.runtime import tracer as RT
from mathmap_tpu.runtime import value as RV
from mathmap_tpu.runtime.options import RenderOptions as RefOptions
from mathmap_tpu_torch.ops import registry as PR
from mathmap_tpu_torch.runtime import tracer as PT
from mathmap_tpu_torch.runtime import value as PV
from mathmap_tpu_torch.runtime.options import RenderOptions

H, W = 6, 7
RTOL, ATOL = 1e-5, 1e-6

#: argument generators: (tag, length, low, high); "s" marks a 0-d scalar
#: component, "q" values rounded to 0.5 so ties and equalities occur
U = ("nil", 1, -2.0, 2.0)
POS = ("nil", 1, 0.1, 3.0)
UNIT = ("nil", 1, -0.95, 0.95)
GE1 = ("nil", 1, 1.0, 4.0)
Q = ("nil", 1, -2.0, 2.0, "q")
S = ("nil", 1, -2.0, 2.0, "s")
RI = ("ri", 2, -1.5, 1.5)
RGBA = ("rgba", 4, 0.0, 1.0)
HSVA = ("hsva", 4, 0.0, 1.0)
XY = ("xy", 2, -3.0, 3.0)
RA = ("ra", 2, 0.0, 6.0)
V3 = ("nil", 3, -2.0, 2.0)

CASES = [
    ("__add", (U, U)), ("__add", (V3, S)), ("__sub", (U, V3)),
    ("__mul", (U, U)), ("__mul", (RI, RI)), ("__mul", (RI, S)),
    ("__div", (U, POS)), ("__div", (RI, RI)), ("__div", (S, RI)),
    ("__mod", (U, POS)), ("__mod", (Q, ("nil", 1, -2.0, -0.5))),
    ("__pow", (POS, U)), ("pow", (POS, S)), ("__pow", (RI, RI)),
    ("__pow", (RI, POS)), ("__neg", (V3,)), ("__not", (Q,)),
    ("__eq", (Q, Q)), ("__ne", (V3, V3)), ("__lt", (Q, Q)), ("__gt", (Q, Q)),
    ("__le", (Q, Q)), ("__ge", (Q, S)), ("__eq", (("nil", 2, 0, 1, "q"),) * 2),
    ("__and", (Q, Q)), ("__or", (Q, Q)), ("__xor", (Q, Q)),
    ("sin", (U,)), ("cos", (U,)), ("tan", (UNIT,)), ("sin", (RI,)),
    ("cos", (RI,)), ("tan", (RI,)), ("exp", (U,)), ("exp", (RI,)),
    ("sqrt", (POS,)), ("sqrt", (RI,)), ("log", (POS,)), ("log", (RI,)),
    ("asin", (UNIT,)), ("acos", (UNIT,)), ("sinh", (U,)), ("cosh", (U,)),
    ("tanh", (U,)), ("asinh", (U,)), ("acosh", (GE1,)), ("atanh", (UNIT,)),
    ("atan", (U,)), ("atan", (U, U)), ("atan2", (U, U)),
    ("floor", (U,)), ("ceil", (U,)), ("round", (Q,)), ("sign", (Q,)),
    ("deg2rad", (U,)), ("rad2deg", (U,)), ("log2", (POS,)), ("log10", (POS,)),
    ("exp2", (U,)), ("fmod", (U, POS)), ("hypot", (U, U)),
    ("min", (U, V3)), ("max", (U, U)), ("clamp", (U, S, POS)),
    ("clamp", (S, RGBA, POS)), ("lerp", (UNIT, V3, V3)), ("scale", (V3, S)),
    ("scale", (U, S, POS, S, POS)), ("inintv", (Q, S, POS)),
    ("smoothstep", (S, POS, U)), ("abs", (U,)), ("abs", (RI,)),
    ("abs", (XY,)), ("conj", (RI,)), ("arg", (RI,)),
    ("rgbColor", (UNIT, S, UNIT)), ("rgbaColor", (U, U, U, U)),
    ("grayColor", (U,)), ("grayaColor", (U, S)), ("red", (RGBA,)),
    ("green", (RGBA,)), ("blue", (RGBA,)), ("alpha", (RGBA,)),
    ("gray", (RGBA,)), ("toHSVA", (RGBA,)), ("toHSVA", (("rgba", 4, 0, 1, "q"),)),
    ("toRGBA", (HSVA,)), ("toRA", (XY,)), ("toXY", (RA,)),
    ("rand", (S, S)), ("rand", (U, U)), ("noise", (V3,)), ("noise", (U, U, S)),
    ("noise", (("nil", 3, -300.0, 300.0),)),
]


def _make(spec, rs):
    tag, n, lo, hi = spec[:4]
    mode = spec[4] if len(spec) > 4 else None
    comps = []
    for _ in range(n):
        if mode == "s":
            a = np.float32(rs.uniform(lo, hi))
            comps.append(np.asarray(a, np.float32))
            continue
        a = rs.uniform(lo, hi, (H, W)).astype(np.float32)
        if mode == "q":
            a = (np.round(a * 2) / 2).astype(np.float32)
        comps.append(a)
    return tag, comps


def _evaluators():
    x = np.zeros((H, W), np.float32)
    ref_ctx = RT.RenderContext(be=np, width=W, height=H, opts=RefOptions(),
                               is_jax=False, dtype=np.float32)
    port_ctx = PT.RenderContext(device=torch.device("cpu"), width=W, height=H,
                                opts=RenderOptions())
    xt = torch.from_numpy(x)
    return (RT.Evaluator(ref_ctx, x, x, {}), PT.Evaluator(port_ctx, xt, xt, {}))


@pytest.mark.parametrize(
    "name,specs", CASES,
    ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_builtin_matches_reference(name, specs):
    rs = np.random.RandomState(zlib.crc32(repr((name, specs)).encode()))
    args = [_make(s, rs) for s in specs]
    ref_ev, port_ev = _evaluators()
    ref = RR.lookup(name)(ref_ev, [RV.TupleValue(t, tuple(c)) for t, c in args], None)
    got = PR.lookup(name)(port_ev, [PV.TupleValue(t, tuple(torch.from_numpy(np.array(a)) for a in c))
                                    for t, c in args], None)
    assert got.tag == ref.tag
    assert len(got.arrays) == len(ref.arrays)
    for g, r in zip(got.arrays, ref.arrays):
        g = g.numpy()
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.broadcast_to(r, g.shape), rtol=RTOL, atol=ATOL)


def test_cases_cover_every_ported_builtin():
    covered = {name for name, _ in CASES}
    assert covered == set(PR.BUILTINS) - {"origVal", "origValXY", "origValImage"}


def test_not_ported_builtins_are_exactly_the_rest():
    """Every reference builtin is either ported or named NOT_PORTED, and a
    call to one of those raises NotImplementedError naming its ROADMAP
    item instead of reporting an unknown function."""
    assert set(PR.BUILTINS) | set(PR.NOT_PORTED) == set(RR.BUILTINS)
    assert not set(PR.BUILTINS) & set(PR.NOT_PORTED)
    for name, item in PR.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=item):
            PR.lookup(name)


def test_port_table_is_its_own():
    """Registering the port's builtins leaves the reference table alone."""
    assert PR.BUILTINS is not RR.BUILTINS
    assert RR.lookup("sin").__module__.startswith("mathmap_tpu.")
    assert PR.lookup("sin").__module__.startswith("mathmap_tpu_torch.")


def test_constant_folding_uses_torch_float32():
    """The fold mirror runs the port's builtin on float32 tensors, like the
    reference's numpy-float32 shadow."""
    from mathmap_tpu_torch.lang.parser import parse

    prog = parse("filter f (image in) v = sin(pi / 3) * 2 ^ 0.5; grayColor(v) end")
    _, ev = _evaluators()
    assign = prog.filters[0].body.items[0]
    v = ev.eval(assign.expr)
    want = np.float32(np.sin(np.float32(np.pi) / np.float32(3))) * np.float32(2) ** np.float32(0.5)
    assert v.const is not None and v.const[0] == pytest.approx(float(want), rel=1e-6)
    assert float(v.arrays[0]) == pytest.approx(v.const[0], rel=1e-7)
