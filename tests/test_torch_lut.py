"""Kernel B2's plain version and the curve/gradient values of the port
against the reference: `apply_lut_reference` against the oracle's
`_lut_take` (numpy backend), the default LUTs, the conversion of curve and
gradient params, and curve/gradient application in renders. Tolerances:
exact for the LUT math (the same float32 operations in the same order);
rtol=1e-4, atol=1e-5 for renders."""

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
from mathmap_tpu.ops.color_ops import _lut_take
from mathmap_tpu.runtime.value import Curve as RefCurve
from mathmap_tpu.runtime.value import Gradient as RefGradient
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import params_from_reference
from mathmap_tpu_torch.kernels.apply_lut import apply_lut, apply_lut_reference
from mathmap_tpu_torch.runtime.value import Curve, Gradient
from mathmap_tpu_torch.utils.trace import counter

RTOL, ATOL = 1e-4, 1e-5


def _positions(seed, shape=(23, 31)):
    """Positions below 0, above 1, exactly 0 and 1, on LUT nodes, inside."""
    rs = np.random.RandomState(seed)
    pos = rs.uniform(-0.5, 1.5, shape).astype(np.float32)
    flat = pos.reshape(-1)
    flat[:4] = [0.0, 1.0, -0.0, 0.5]
    flat[4:40] = rs.randint(0, 9, 36) / np.float32(8.0)
    return pos


@pytest.mark.parametrize("channels", [1, 4])
@pytest.mark.parametrize("k", [2, 256, 5000])
def test_plain_version_equals_the_oracle_lut_take(k, channels):
    rs = np.random.RandomState(k + channels)
    lut = rs.rand(k).astype(np.float32) if channels == 1 else rs.rand(k, channels).astype(np.float32)
    pos = _positions(k)
    want = _lut_take(np, lut, pos)
    got = apply_lut_reference(torch.from_numpy(lut), torch.from_numpy(pos))
    assert got.shape == (channels, *pos.shape) and got.dtype == torch.float32
    for ch in range(channels):
        np.testing.assert_array_equal(got[ch].numpy(), want[ch])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    lut = torch.from_numpy(np.random.RandomState(1).rand(256, 4).astype(np.float32))
    pos = torch.from_numpy(_positions(2))
    before = counter("launch.apply_lut")
    assert torch.equal(apply_lut(lut, pos), apply_lut_reference(lut, pos))
    assert counter("launch.apply_lut") == before  # CPU calls never count


def test_zero_d_position_and_nan():
    lut = torch.tensor([0.0, 1.0, 4.0])
    assert float(apply_lut_reference(lut, torch.tensor(0.75))[0]) == pytest.approx(2.5)
    out = apply_lut_reference(lut, torch.tensor([float("nan"), 2.0]))
    assert torch.isnan(out[0, 0]) and float(out[0, 1]) == 4.0


@pytest.mark.parametrize("bad", [torch.zeros(4, 3), torch.zeros(2, 2, 4), torch.zeros(4, dtype=torch.float64)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((ValueError, TypeError)):
        apply_lut(bad, torch.zeros(3, 3))


def test_default_luts_equal_the_reference():
    np.testing.assert_array_equal(Curve.identity("cpu").lut.numpy(), RefCurve.identity(np).lut)
    np.testing.assert_array_equal(Gradient.default("cpu").lut.numpy(), RefGradient.default(np).lut)
    np.testing.assert_array_equal(Curve.identity("cpu", 1000).lut.numpy(),
                                  RefCurve.identity(np, 1000).lut)


def test_curve_from_function_equals_the_reference():
    got = Curve.from_function("cpu", lambda t: t * t).lut
    want = RefCurve.from_function(np, lambda t: t * t).lut
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_reference_carries_curves_and_gradients():
    curve = RefCurve.from_function(np, lambda t: 1 - t)
    grad = RefGradient.default(np)
    out = params_from_reference({"c": curve, "g": grad,
                                 "a3": np.ones((5, 3), np.float64),
                                 "a1": np.linspace(0, 1, 7)})
    np.testing.assert_array_equal(out["c"], curve.lut)
    np.testing.assert_array_equal(out["g"], grad.lut)
    assert out["a3"].shape == (5, 3) and out["a3"].dtype == np.float32
    assert out["a1"].shape == (7,) and out["a1"].dtype == np.float32


@pytest.mark.parametrize("value", [np.zeros((4, 2)), np.zeros(1), lambda t: t])
def test_params_from_reference_refuses_other_luts(value):
    with pytest.raises(TypeError):
        params_from_reference({"p": value})


CURVE_SRC = "filter f (image in, curve c) p = in(xy); rgbaColor(c(red(p)), c(green(p)), c(blue(p)), alpha(p)) end"
GRAD_SRC = "filter f (image in, gradient g) g(gray(in(xy)) * 1.4 - 0.2) end"


def _image():
    img = np.random.RandomState(3).rand(16, 20, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


@pytest.mark.parametrize("value", [
    None,
    np.linspace(1, 0, 9).astype(np.float32),
    np.random.RandomState(4).rand(300).astype(np.float32),
])
def test_curve_param_renders_like_the_oracle(value):
    params = {} if value is None else {"c": value}
    ref = mm.compile(CURVE_SRC).render(_image(), params=params, interpret=True)
    got = mt.compile_source(CURVE_SRC).render(_image(), params=params, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("value", [
    None,
    np.random.RandomState(5).rand(7, 3).astype(np.float32),
    np.random.RandomState(6).rand(64, 4).astype(np.float32),
])
def test_gradient_param_renders_like_the_oracle(value):
    params = {} if value is None else {"g": value}
    ref = mm.compile(GRAD_SRC).render(_image(), params=params, interpret=True)
    got = mt.compile_source(GRAD_SRC).render(_image(), params=params, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_curve_and_gradient_objects_and_callables_as_params():
    img = _image()
    f = mt.compile_source(CURVE_SRC)
    a = f.render(img, params={"c": Curve.from_function("cpu", lambda t: t ** 2)}, device="cpu")
    b = f.render(img, params={"c": lambda t: t ** 2}, device="cpu")
    assert torch.equal(a, b)
    g = mt.compile_source(GRAD_SRC)
    lut = torch.rand(32, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(g.render(img, params={"g": Gradient(lut=lut)}, device="cpu"),
                       g.render(img, params={"g": lut.numpy()}, device="cpu"))


@pytest.mark.parametrize("src,params", [
    (CURVE_SRC, {"c": np.zeros((4, 4), np.float32)}),
    (GRAD_SRC, {"g": np.zeros(8, np.float32)}),
    (GRAD_SRC, {"g": np.zeros((8, 2), np.float32)}),
])
def test_bad_lut_params_raise(src, params):
    with pytest.raises(mt.MMTypeError):
        mt.compile_source(src).render(_image(), params=params, device="cpu")


def test_curve_application_needs_one_argument():
    f = mt.compile_source("filter f (image in, curve c) grayColor(c(0.1, 0.2)) end")
    with pytest.raises(mt.MMTypeError, match="one argument"):
        f.render(_image(), device="cpu")


def test_constant_position_applies_like_the_oracle():
    src = "filter f (image in, gradient g) g(0.3) end"
    ref = mm.compile(src).render(_image(), interpret=True)
    got = mt.compile_source(src).render(_image(), device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
