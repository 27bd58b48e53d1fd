"""The float64 spec on the port's CPU route: `Filter.render(...,
interpret=True, precision="f64")` against the reference's own float64
spec, `mathmap_tpu`'s `render(..., interpret=True, precision="f64")` (the
NumPy oracle in float64), on numpy-seeded inputs at 64x48.

Every case is held at rtol=1e-9, atol=1e-9 and to the oracle's output
dtype: the port and the spec run the same operations in the same dtypes,
with numpy's trig, sqrt and pow on both sides (ops/libm.py), so the
escape-time loops (mandelbrot, quat_julia) land on the same iteration
counts at every pixel and test_parity.py's 98% pixel rule is not needed.
One stated exception: gamma, beta and ri: gamma of a float32 argument
(comparison masks) carry torch's float32 exp and log, an ulp from numpy's
(measured up to 7.0e-8; atol=1e-7 there).
Also here: the reference's own float64 claims (test_parity.py and
test_fuzz.py) on the port, NumPy's promotion rule (runtime/promotion.py)
and the refusals of `interpret` with another device and of
`on_error="interpret"`."""

import os

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.expression_db import default_db as reference_db
from mathmap_tpu_torch.ops import libm
from mathmap_tpu_torch.runtime.promotion import NumpyPromotion
from mathmap_tpu_torch.utils.trace import since, snapshot
from test_fuzz import ExprGen
from test_fuzz import H as FUZZ_H
from test_fuzz import W as FUZZ_W
from test_torch_render import OPTION_SETS

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H = 64, 48
RTOL = ATOL = 1e-9


def _image(seed, dtype):
    rs = np.random.RandomState(seed)
    if dtype == "u8":
        return rs.randint(0, 256, size=(H, W, 4), dtype=np.uint8)
    img = rs.rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _spec_pair(ref, port, inputs, **kw):
    """(oracle, port) float64 spec renders of one filter, as numpy."""
    opts = kw.pop("options", {})
    o = ref.render(*inputs, interpret=True, precision="f64",
                   options=mm.RenderOptions(**opts), **kw)
    g = port.render(*inputs, interpret=True, precision="f64",
                    options=mt.RenderOptions(**opts), **kw)
    assert g.device.type == "cpu"
    return o, g.numpy()


def _assert_spec(o, g, what):
    assert g.dtype == o.dtype, (what, g.dtype, o.dtype)
    np.testing.assert_allclose(g, o, rtol=RTOL, atol=ATOL, err_msg=str(what))


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("opts", OPTION_SETS, ids=lambda o: "-".join(map(str, o.values())))
@pytest.mark.parametrize("name", ["fisheye", "twirl", "pond"])
def test_distortion_suite_matches_the_f64_spec(name, opts, dtype):
    path = os.path.join(ROOT, "filters", "Distorts", f"{name}.mm")
    o, g = _spec_pair(mm.compile_file(path), mt.compile_file(path),
                      [_image(5, dtype)], t=0.3, options=opts)
    assert g.dtype == np.float64
    _assert_spec(o, g, (name, opts, dtype))


_LUT = np.cumsum(np.random.RandomState(8).rand(64)).astype(np.float32)
_LUT /= _LUT[-1]
#: library entries by feature: loops (mandelbrot, quat_julia through the
#: masked loop), LUTs (a curve and a gradient param), noise, rand(),
#: gaussian_blur, and the two entries whose masks and draws meet float64
#: scalars (old_photo, stars: NumPy's promotion decides their values)
LIBRARY_CASES = {
    "mandelbrot": {},
    "quat_julia": {},
    "curve_adjust": {"c": _LUT},
    "gradient_map": {"g": np.random.RandomState(9).rand(16, 3).astype(np.float32)},
    "voronoi": {},
    "turbulence": {},
    "static_tv": {},
    "sharpen": {},
    "old_photo": {},
    "stars": {},
}


@pytest.mark.parametrize("name", sorted(LIBRARY_CASES))
def test_library_filters_match_the_f64_spec(name):
    port, ref = mt.default_db().compile(name), reference_db().compile(name)
    inputs = [_image(11 + i, "f32") for i in range(len(port.image_params))]
    o, g = _spec_pair(ref, port, inputs, width=W, height=H, t=0.3,
                      params=LIBRARY_CASES[name])
    assert np.isfinite(g).all()
    _assert_spec(o, g, name)


@pytest.mark.parametrize("name", ["curve_adjust", "gradient_map"])
def test_lut_filters_on_u8_input_match_the_f64_spec(name):
    port, ref = mt.default_db().compile(name), reference_db().compile(name)
    o, g = _spec_pair(ref, port, [_image(12, "u8")], params=LIBRARY_CASES[name])
    _assert_spec(o, g, name)


def test_u8_image_param_stays_float32_in_the_spec():
    """A u8 image param is float32 /255 in the spec (the reference's user
    value conversion) while the positional input is float64: its nearest
    taps come back float32, and everything they meet decides the rest."""
    src = ("filter m (image in, image other)\n"
           "  p = other(xy + [sin(y / 4) * 3, 0]); q = in(xy);\n"
           "  rgbaColor(red(p), green(q) * 0.5, blue(p) * 0.25 + blue(q), 1)\nend")
    params = {"other": _image(13, "u8")}
    for interp in ("nearest", "bilinear"):
        o, g = _spec_pair(mm.compile(src), mt.compile_source(src), [_image(14, "u8")],
                          params=params, options={"interpolation": interp})
        _assert_spec(o, g, interp)


@pytest.mark.parametrize("seed", range(40, 60))
def test_random_expression_matches_the_f64_spec_supersampled(seed):
    """tests/test_fuzz.py's ExprGen seeds 40-59 at supersample=2, the
    cases the reference renders in float64."""
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(FUZZ_H, FUZZ_W, 4).astype(np.float32)
    img[..., 3] = 1.0
    o, g = _spec_pair(mm.compile(src), mt.compile_source(src), [img],
                      options={"supersample": 2})
    _assert_spec(o, g, src)


#: a float32 argument in {1, 2}: a sum of comparison masks
_MASKS = "((x > 0) + (x <= 0) + (y > 0))"


@pytest.mark.parametrize("src,atol", [
    ("grayColor(lgamma((x > 0) + (y > 0)) / 4)", ATOL),
    # torch's float32 exp and log on the CPU are an ulp from numpy's, which
    # the Lanczos product carries: measured 2.6e-8 (gamma), 7.0e-8 (beta),
    # 5.2e-8 (ri: gamma) at 16x12
    (f"grayColor(gamma({_MASKS}) / 4)", 1e-7),
    (f"grayColor(beta({_MASKS}, (y < 0) + (y >= 0) + (x < 0)) * 2)", 1e-7),
    (f"g = gamma(ri:[{_MASKS}, y > 0]); grayColor(g[0] / 4 + g[1])", 1e-7),
])
def test_special_functions_of_float32_masks_take_the_f64_constants(src, atol):
    """The spec's sqrt(2 pi), log(2 pi) and log(pi) are float64 scalars that
    promote a float32 argument (special_ops._constants)."""
    img = np.random.RandomState(0).rand(12, 16, 4).astype(np.float32)
    o, g = _spec_pair(mm.compile(src), mt.compile_source(src), [img])
    assert g.dtype == o.dtype == np.float64
    np.testing.assert_allclose(g, o, rtol=RTOL, atol=atol, err_msg=src)


def test_uint8_output_packs_the_f64_spec():
    path = os.path.join(ROOT, "filters", "Distorts", "twirl.mm")
    o, g = _spec_pair(mm.compile_file(path), mt.compile_file(path), [_image(3, "u8")],
                      options={"output_dtype": "uint8"})
    assert g.dtype == o.dtype == np.uint8
    np.testing.assert_array_equal(g, o)


def test_animated_input_region_and_corners_match_the_f64_spec():
    src = "filter a (image in) origValXY(x + sin(y / 3), y, 1) end"
    anim = np.random.RandomState(4).rand(3, H, W, 4).astype(np.float32)
    for opts in ({"region": (5, 7, 30, 20)},
                 {"supersample": 2, "supersample_scheme": "corners"}):
        o, g = _spec_pair(mm.compile(src), mt.compile_source(src), [anim], frame=2.0,
                          options=opts)
        _assert_spec(o, g, opts)


# -- the reference's own float64 claims, on the port -------------------------

def test_oracle_f64_precision_mode():
    """tests/test_parity.py::test_oracle_f64_precision_mode: the f64 spec
    is float64, and the float32 renders stay within f32 tolerance of it."""
    f = mt.compile_source("grayColor(0.5 + 0.5 * sin(r * 0.3 - a))")
    img = np.random.RandomState(0).rand(H, W, 4).astype(np.float32)
    o64 = f.render(img, interpret=True, precision="f64").numpy()
    assert o64.dtype == np.float64
    o32 = f.render(img, interpret=True).numpy()
    cpu = f.render(img, device="cpu").numpy()
    np.testing.assert_allclose(o32, o64, atol=2e-6)
    np.testing.assert_allclose(cpu, o64, atol=1e-5)


@pytest.mark.parametrize("seed", range(40, 60))
def test_random_expression_supersampled_and_f64(seed):
    """tests/test_fuzz.py::test_random_expression_supersampled_and_f64 on
    the port: its float32 render within 2e-4 of its float64 spec."""
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(FUZZ_H, FUZZ_W, 4).astype(np.float32)
    img[..., 3] = 1.0
    f = mt.compile_source(src)
    opts = mt.RenderOptions(supersample=2)
    o32 = f.render(img, interpret=True, options=opts).numpy()
    o64 = f.render(img, interpret=True, precision="f64", options=opts).numpy()
    assert np.isfinite(o32).all(), src
    np.testing.assert_allclose(o32, o64, atol=2e-4, err_msg=src)


# -- the keywords ---------------------------------------------------------------

def test_interpret_equals_the_cpu_render_bit_for_bit():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "pond.mm"))
    img = _image(6, "u8")
    for precision in ("f32", "bf16"):
        a = f.render(img, interpret=True, precision=precision, t=0.4)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, f.render(img, device="cpu", t=0.4))
    assert torch.equal(f.render(img, interpret=True, device="cpu"),
                       f.render(img, device="cpu"))


def test_precision_without_interpret_renders_float32():
    """The reference's jit path ignores `precision`; so does the port's
    device route (here the CPU as the named device)."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    img = _image(7, "f32")
    out = f.render(img, precision="f64", device="cpu")
    assert out.dtype == torch.float32
    assert torch.equal(out, f.render(img, device="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a GPU")
def test_the_default_device_is_still_the_card():
    f = mt.compile_source("filter g () grayColor(x) end")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        f.render(width=4, height=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        f.render(width=4, height=4, precision="f64")


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("meta")])
def test_interpret_with_another_device_raises(device):
    f = mt.compile_source("filter g () grayColor(x) end")
    with pytest.raises(ValueError, match="interpret=True.*device="):
        f.render(width=4, height=4, interpret=True, device=device)


@pytest.mark.parametrize("interpret", [False, True])
def test_on_error_interpret_raises(interpret):
    f = mt.compile_source("filter g () grayColor(x) end")
    with pytest.raises(ValueError, match="on_error='interpret'"):
        f.render(width=4, height=4, interpret=interpret, device="cpu" if not interpret else None,
                 on_error="interpret")
    # any other value is accepted, as in the reference
    out = f.render(width=4, height=4, interpret=True, on_error="warn")
    assert out.shape == (4, 4, 4)


# -- the pieces -------------------------------------------------------------------

def test_numpy_promotion_follows_numpy():
    a32 = np.linspace(-1, 1, 5, dtype=np.float32)
    s64 = np.array(0.1)
    with NumpyPromotion():
        for op in (torch.mul, torch.add, torch.lt, torch.maximum):
            got = op(torch.from_numpy(a32), torch.from_numpy(s64))
            want = {torch.mul: np.multiply, torch.add: np.add, torch.lt: np.less,
                    torch.maximum: np.maximum}[op](a32, s64)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
        stacked = torch.stack([torch.from_numpy(a32), torch.from_numpy(a32.astype(np.float64))])
        assert stacked.dtype == torch.float64
        picked = torch.where(torch.from_numpy(a32) > 0, torch.from_numpy(a32),
                             torch.tensor(0.3, dtype=torch.float64))
        assert picked.dtype == torch.float64
        # conversions, views and the package's ops keep their arguments
        kept = torch.from_numpy(a32).to(torch.float64).to(torch.float32)
        assert kept.dtype == torch.float32
        # float32 with Python scalars stays float32, as in NumPy
        assert (torch.from_numpy(a32) * 0.1).dtype == torch.float32
    # outside the mode torch's own rule applies
    assert (torch.from_numpy(a32) * torch.from_numpy(s64)).dtype == torch.float32


@pytest.mark.parametrize("name", sorted(libm.FUNCTIONS))
def test_cpu_float64_libm_is_numpys(name):
    rs = np.random.RandomState(2)
    lo, hi = {"acosh": (1.0, 9.0), "asin": (-1.0, 1.0), "acos": (-1.0, 1.0),
              "atanh": (-0.99, 0.99), "sqrt": (0.0, 9.0), "pow": (0.1, 3.0)}.get(
                  name, (-6.0, 6.0))
    n_args = 2 if name in ("atan2", "pow") else 1
    args = [rs.uniform(lo, hi, 257) for _ in range(n_args)]
    got = libm.FUNCTIONS[name](*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), libm._NUMPY[name](*args))


def test_a_float64_loop_takes_the_masked_loop():
    """B3 is a float32 kernel: under the spec an eligible loop runs as the
    masked eager loop, as in the reference's oracle; the float32 CPU
    render of the same loop routes through the kernel's wrapper."""
    path = os.path.join(ROOT, "filters", "Render", "mandelbrot.mm")
    f = mt.compile_file(path)
    for precision, route in (("f64", "loop.masked"), ("f32", "loop.kernel")):
        before = snapshot()
        f.render(width=24, height=16, interpret=True, precision=precision)
        counters = since(before)["counters"]
        assert [k for k in counters if k.startswith("loop.") and "steps" not in k] == [route]
        assert counters[route] == 1


def test_kernel_wrappers_take_float64_on_the_cpu_only():
    from mathmap_tpu_torch.kernels.apply_lut import apply_lut
    from mathmap_tpu_torch.kernels.sample_image import sample_image

    pix = torch.rand(5, 6, 4)
    x = torch.rand(3, 4, dtype=torch.float64)
    out = sample_image(pix, x, x.clone(), "bilinear", "color", "color", (0, 0, 0, 0))
    assert out.dtype == torch.float64
    assert apply_lut(torch.rand(8), x).dtype == torch.float64
    meta = x.to("meta")
    with pytest.raises(TypeError, match="float32"):
        sample_image(pix.to("meta"), meta, meta, "bilinear", "color", "color", (0,) * 4)
    with pytest.raises(TypeError, match="float32"):
        apply_lut(torch.rand(8, device="meta"), meta)
