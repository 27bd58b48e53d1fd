"""Each builtin the port has, on seeded inputs, against the reference builtin
on the NumPy backend (an oracle Evaluator). Both sides compute elementwise
float32, so the tolerance is rtol=1e-5, atol=1e-6 (the oracle's gamma,
lgamma and beta finish in float64, ops/special_ops.py; the port's float32
stays inside the same tolerance). gaussian_blur returns an image: its
pixels are compared."""

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
V2 = ("v2", 2, -2.0, 2.0)
V3T = ("v3", 3, -2.0, 2.0)
M2 = ("m2x2", 4, -2.0, 2.0)
M3 = ("m3x3", 9, -2.0, 2.0)
QUAT = ("quat", 4, -1.5, 1.5)
CQUAT = ("cquat", 4, -1.5, 1.5)
HYPER = ("hyper", 4, -1.5, 1.5)
GAMMA_ARG = ("nil", 1, 0.05, 6.0)
REFLECTED = ("nil", 1, -2.95, 0.45)
UNIT_S = ("nil", 1, -0.95, 0.95, "s")
#: "c": a 0-d scalar that carries its host-side const, as a literal does
SIGMA = ("nil", 1, 0.4, 2.5, "c")
#: an (H, W, 4) float32 image in [0, 1]
IMAGE = ("image", 1, 0.0, 1.0)

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
    # vectors, matrices, quaternions (ops/vector_ops.py)
    ("dotp", (V3, V3)), ("dotp", (QUAT, RGBA)), ("crossp", (V3, V3T)),
    ("normalize", (V3T,)), ("normalize", (("xy", 2, -1.0, 1.0, "q"),)),
    ("length", (V3,)), ("length", (RGBA,)), ("det", (M2,)), ("det", (M3,)),
    ("solve", (M2, V2)), ("solve", (M3, V3)), ("__mul", (M2, M2)),
    ("__mul", (M2, XY)), ("__mul", (M3, M3)), ("__mul", (M3, V3T)),
    ("__mul", (S, M2)), ("__mul", (M3, U)), ("__mul", (QUAT, QUAT)),
    ("__mul", (CQUAT, CQUAT)), ("__mul", (HYPER, HYPER)),
    # special functions (ops/special_ops.py)
    ("gamma", (GAMMA_ARG,)), ("gamma", (REFLECTED,)), ("gamma", (("ri", 2, 0.6, 2.5),)),
    ("lgamma", (("nil", 1, 0.05, 40.0),)), ("lgamma", (REFLECTED,)),
    ("beta", (GAMMA_ARG, POS)), ("ellK", (UNIT,)), ("ell_int_Kcomp", (UNIT,)),
    ("ellE", (UNIT,)), ("ell_int_Ecomp", (UNIT,)), ("ell_jac_sn", (U, UNIT)),
    ("ell_jac_cn", (U, UNIT)), ("ell_jac_dn", (U, UNIT)), ("jac_sn", (POS, UNIT_S)),
    ("jac_cn", (POS, UNIT_S)), ("jac_dn", (POS, UNIT_S)),
    # whole-image filters (runtime/native_filters.py)
    ("gaussian_blur", (IMAGE, SIGMA)), ("gaussian-blur", (IMAGE, SIGMA)),
    ("gaussianBlur", (IMAGE, SIGMA)),
]


def _make(spec, rs):
    tag, n, lo, hi = spec[:4]
    mode = spec[4] if len(spec) > 4 else None
    comps = []
    if tag == "image":
        return tag, [rs.uniform(lo, hi, (H, W, 4)).astype(np.float32)]
    for _ in range(n):
        if mode in ("s", "c"):
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


def _values(spec, tag, comps):
    """(reference TupleValue, port TupleValue) of one generated argument."""
    if tag == "image":
        return (RV.image_value(RV.InputImage(pixels=comps[0])),
                PV.image_value(PV.InputImage(pixels=torch.from_numpy(comps[0]))))
    const = tuple(float(c) for c in comps) if spec[4:] == ("c",) else None
    return (RV.TupleValue(tag, tuple(comps), const=const),
            PV.TupleValue(tag, tuple(torch.from_numpy(np.array(a)) for a in comps),
                          const=const))


@pytest.mark.parametrize(
    "name,specs", CASES,
    ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_builtin_matches_reference(name, specs):
    rs = np.random.RandomState(zlib.crc32(repr((name, specs)).encode()))
    args = [_values(s, *_make(s, rs)) for s in specs]
    ref_ev, port_ev = _evaluators()
    ref = RR.lookup(name)(ref_ev, [r for r, _ in args], None)
    got = PR.lookup(name)(port_ev, [p for _, p in args], None)
    assert got.tag == ref.tag
    if ref.is_opaque:
        # an image result: its pixels
        ref, got = (RV.TupleValue("rgba", (ref.payload.pixels,)),
                    PV.TupleValue("rgba", (got.payload.pixels,)))
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
