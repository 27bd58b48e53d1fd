"""The slice as a whole: fisheye, twirl and pond through the port on the CPU
against the reference's NumPy oracle (`interpret=True`), the 8-bit goldens,
and the parts of the system the port does not have yet raising
NotImplementedError with their ROADMAP item."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import options_from_reference

ROOT = os.path.join(os.path.dirname(__file__), "..")
DISTORTS = os.path.join(ROOT, "filters", "Distorts")
FILTERS = ("fisheye", "twirl", "pond")
OTHER_PARAMS = {
    "fisheye": {"strength": 1.5},
    "twirl": {"angle": -4.0},
    "pond": {"amplitude": 9.0, "wavelength": 31.0, "phase": 1.1},
}
#: every option set of tests/test_parity.py::test_sampling_option_parity
OPTION_SETS = [
    dict(interpolation="nearest"),
    dict(interpolation="bilinear"),
    dict(interpolation="bicubic"),
    dict(interpolation="bilinear", edge_x="wrap", edge_y="wrap"),
    dict(interpolation="bilinear", edge_x="reflect", edge_y="reflect"),
    dict(interpolation="bicubic", edge_x="wrap", edge_y="reflect"),
    dict(supersample=2),
]
SIZES = ((20, 16), (64, 48))
RTOL, ATOL = 1e-4, 1e-5


def _image(w, h, seed, dtype):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    if dtype == "u8":
        return np.floor(img * 255 + 0.5).astype(np.uint8)
    return img


def _pair(name):
    path = os.path.join(DISTORTS, f"{name}.mm")
    return mt.compile_file(path), mm.compile_file(path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("params", ["default", "other"])
@pytest.mark.parametrize("opts", range(len(OPTION_SETS)))
@pytest.mark.parametrize("name", FILTERS)
def test_port_matches_oracle(name, opts, params, dtype, size):
    w, h = size
    port, ref = _pair(name)
    img = _image(w, h, seed=10, dtype=dtype)
    prm = OTHER_PARAMS[name] if params == "other" else {}
    ref_opts = mm.RenderOptions(**OPTION_SETS[opts])
    want = ref.render(img, width=w, height=h, t=0.3, options=ref_opts,
                      params=prm, interpret=True)
    got = port.render(img, width=w, height=h, t=0.3, params=prm,
                      options=options_from_reference(ref_opts), device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FILTERS)
def test_uint8_output_matches_goldens(name):
    """tests/goldens.json pins the uint8-packed oracle render at 20x16,
    t=0.3, input seed 11 (tests/make_goldens.py); the port's on-device
    packing reproduces the hash."""
    with open(os.path.join(ROOT, "tests", "goldens.json")) as fh:
        goldens = json.load(fh)
    port, _ = _pair(name)
    img = _image(20, 16, seed=11, dtype="f32")
    out = port.render(img, width=20, height=16, t=0.3, device="cpu",
                      options=mt.RenderOptions(output_dtype="uint8"))
    assert out.dtype == torch.uint8
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == goldens[name]


def test_uint8_output_is_the_packed_float_output():
    port, _ = _pair("twirl")
    img = _image(64, 48, seed=4, dtype="u8")
    f = port.render(img, device="cpu").numpy()
    u = port.render(img, device="cpu",
                    options=mt.RenderOptions(output_dtype="uint8")).numpy()
    np.testing.assert_array_equal(u, np.floor(np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_tensor_inputs_render_like_numpy_inputs():
    port, _ = _pair("pond")
    img = _image(40, 30, seed=2, dtype="u8")
    a = port.render(img, device="cpu")
    b = port.render(torch.from_numpy(img), device="cpu")
    assert torch.equal(a, b)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    port, _ = _pair("fisheye")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port.render(_image(20, 16, 0, "f32"))  # device defaults to "cuda"


def test_unknown_param_name_raises():
    port, _ = _pair("twirl")
    with pytest.raises(ValueError, match="unknown param"):
        port.render(_image(20, 16, 0, "f32"), params={"angel": 2.0}, device="cpu")


NOT_PORTED = {
    "while": ("v = 0; while v < 3 do v = v + 1 end; grayColor(v / 3)", {}, "ROADMAP A3"),
    "rand": ("grayColor(rand(0, 1))", {}, "ROADMAP A3"),
    "noise": ("grayColor(noise([x, y, 0]))", {}, "ROADMAP A3"),
    "curve": ("filter f (image in, curve c) grayColor(c(0.5)) end", {}, "ROADMAP A6"),
    "gradient": ("filter f (image in, gradient g) g(0.5) end", {}, "ROADMAP A6"),
    "quaternion": ("q = quat:[1, 2, 3, 4] * quat:[1, 0, 0, 0]; rgbaColor(q[0], q[1], q[2], 1)",
                   {}, "ROADMAP A7"),
}


@pytest.mark.parametrize("what", sorted(NOT_PORTED))
def test_unported_language_features_raise(what):
    src, params, item = NOT_PORTED[what]
    f = mt.compile_source(src)
    with pytest.raises(NotImplementedError, match=item):
        f.render(_image(20, 16, 0, "f32"), params=params, device="cpu")


@pytest.mark.parametrize("opts", [dict(region=(0, 0, 4, 4)),
                                  dict(supersample=2, supersample_scheme="corners")])
def test_unported_options_raise(opts):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        mt.RenderOptions(**opts)


@pytest.mark.parametrize("entry,item", [("render_batch", "A4"), ("render_animation", "A4"),
                                        ("render_sharded", "A9"), ("render_tiled", "A9")])
def test_unported_entry_points_raise(entry, item):
    port, _ = _pair("twirl")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        getattr(port, entry)(_image(20, 16, 0, "f32"))


def test_animated_input_raises():
    port, _ = _pair("twirl")
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        port.render(np.zeros((2, 16, 20, 4), np.float32), device="cpu")
