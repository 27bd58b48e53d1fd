"""The port as a whole on the CPU: the distortion suite (fisheye, twirl,
pond) and the generative slice (mandelbrot, the escape-time fractals and
the other entries that curves, gradients and loops unblock) against the
reference's NumPy oracle (`interpret=True`, rtol=1e-4, atol=1e-5); the
8-bit goldens of every library .mm entry and of the 22 .mmc compositions
of the port's default_db(), bit for bit (the rand() and noise entries
among them; tests/test_torch_rand.py and test_torch_noise.py hold those
against the oracle at 64x48); and every feature the port does not have
yet raising NotImplementedError with its ROADMAP item (and those once
refused, against the oracle)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.lang.parser import parse

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


GENERATIVE = {
    # name -> (category, non-default params)
    "mandelbrot": ("Render", {"maxiter": 100, "zoom": 2.5, "cx": -0.7, "cy": 0.2,
                              "grad": np.random.RandomState(1).rand(9, 3).astype(np.float32)}),
    "julia": ("Render", {"maxiter": 50, "cre": -0.4, "cim": 0.6,
                         "grad": np.random.RandomState(2).rand(33, 4).astype(np.float32)}),
    "burning_ship": ("Render", {"maxiter": 40, "zoom": 1.5}),
    "tricorn": ("Render", {"maxiter": 30, "zoom": 1.2,
                           "grad": np.random.RandomState(3).rand(5, 4).astype(np.float32)}),
    "biomorph": ("Render", {"maxiter": 12, "cre": 0.3}),
    "newton": ("Render", {"maxiter": 10}),
    "sierpinski": ("Render", {"depth": 3, "fg": (1.0, 0.0, 0.0, 1.0), "bg": (0.0, 0.0, 1.0)}),
    "lissajous": ("Render", {"fx": 5, "fy": 2, "thickness": 0.05}),
    "gradient_test": ("Render", {"g": np.random.RandomState(4).rand(17, 3).astype(np.float32)}),
    "rose_curve": ("Render", {"petals": 7, "size": 0.5,
                              "grad": np.random.RandomState(5).rand(12, 4).astype(np.float32)}),
    "superformula": ("Render", {"m": 3, "n1": 0.5,
                                "grad": np.random.RandomState(6).rand(40, 3).astype(np.float32)}),
    "gradient_map": ("Colors", {"g": np.random.RandomState(7).rand(300, 4).astype(np.float32)}),
    "curve_adjust": ("Colors", {"c": np.random.RandomState(8).rand(20).astype(np.float32)}),
    "do_while_demo": ("Distorts", {"factor": 0.6, "steps": 5}),
}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("params", ["default", "other"])
@pytest.mark.parametrize("name", sorted(GENERATIVE))
def test_generative_entries_match_oracle(name, params, size):
    w, h = size
    category, other = GENERATIVE[name]
    path = os.path.join(ROOT, "filters", category, f"{name}.mm")
    port, ref = mt.compile_file(path), mm.compile_file(path)
    inputs = [_image(w, h, seed=12, dtype="f32")] * sum(
        1 for p in port.fdef.params if p.kind == "image")
    prm = other if params == "other" else {}
    want = ref.render(*inputs, width=w, height=h, t=0.3, params=prm, interpret=True)
    got = port.render(*inputs, width=w, height=h, t=0.3, params=prm, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _library():
    """name -> (path, program, FilterDef) for every filter of filters/**/*.mm,
    parsed by the port; the first definition of a name wins, in the scan
    order of the reference's ExpressionDB (the goldens' entries)."""
    root = os.path.join(ROOT, "filters")
    entries = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if fn.endswith(".mm"):
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    program = parse(fh.read())
                for fdef in program.filters:
                    entries.setdefault(fdef.name, (path, program, fdef))
    return entries


LIBRARY = _library()
#: entries whose angle `a` (atan2) and trig an ulp of torch's CPU libm
#: used to flip by one 8-bit level (ROADMAP C1, closed): the CPU route now
#: computes them with numpy's float32 ufuncs, the oracle's own (ops/libm.py)
LIBM_ULP = ("rose_curve",)
RENDERED = sorted(LIBRARY)
#: the .mmc compositions of filters/Compositions, by the name default_db()
#: gives each
COMPOSITIONS = sorted(os.path.splitext(n)[0] for n in os.listdir(
    os.path.join(ROOT, "filters", "Compositions")) if n.endswith(".mmc"))


def _library_filter(name):
    """The entry as a port Filter with every library filter in scope (file-
    local definitions shadow library ones), like ExpressionDB.compile."""
    _path, program, fdef = LIBRARY[name]
    f = mt.Filter(program, fdef)
    f.filters = {**{n: d for n, (_f, _p, d) in LIBRARY.items()}, **f.filters}
    return f


def _goldens_render(name, f=None):
    """The uint8 render at the goldens geometry (tests/make_goldens.py):
    20x16, t=0.3, image inputs seeded 11+i, color params alternating."""
    f = f or _library_filter(name)
    inputs = [_image(20, 16, seed=11 + i, dtype="f32")
              for i, p in enumerate(p for p in f.fdef.params if p.kind == "image")]
    params = {p.name: (0.8, 0.3, 0.1, 1.0) if i % 2 else (0.1, 0.4, 0.9, 1.0)
              for i, p in enumerate(f.fdef.params) if p.kind == "color"}
    return f.render(*inputs, width=20, height=16, t=0.3, params=params, device="cpu",
                    options=mt.RenderOptions(output_dtype="uint8"))


def test_library_entries_are_the_goldens_entries():
    with open(os.path.join(ROOT, "tests", "goldens.json")) as fh:
        goldens = json.load(fh)
    assert set(LIBRARY) <= set(goldens) and len(LIBRARY) == 155
    assert set(LIBM_ULP) <= set(LIBRARY)
    assert len(COMPOSITIONS) == 22 and set(COMPOSITIONS) == set(goldens) - set(LIBRARY)


@pytest.mark.parametrize("name", RENDERED)
def test_uint8_output_matches_goldens(name):
    """tests/goldens.json pins the uint8-packed oracle render at 20x16,
    t=0.3, input seed 11 (tests/make_goldens.py); the port's on-device
    packing reproduces the hash."""
    with open(os.path.join(ROOT, "tests", "goldens.json")) as fh:
        goldens = json.load(fh)
    out = _goldens_render(name)
    assert out.dtype == torch.uint8
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == goldens[name]


@pytest.mark.parametrize("name", LIBM_ULP)
def test_uint8_output_within_one_level_of_the_oracle(name):
    """The entries whose goldens an ulp of libm used to flip: equal to the
    oracle's uint8 render."""
    from mathmap_tpu.imgio.images import to_uint8

    path, _program, _fdef = LIBRARY[name]
    ref = mm.compile_file(path, main=name).render(width=20, height=16, t=0.3,
                                                  interpret=True)
    diff = np.abs(_goldens_render(name).numpy().astype(int) - to_uint8(ref).astype(int))
    assert diff.max() == 0


#: the entries once refused, for the ROADMAP item each one waited on
ONCE_UNRENDERED = {
    **dict.fromkeys(("affine", "elliptic_rings", "gamma_spiral", "quat_julia",
                     "rotate"), "ROADMAP A7"),
    "sharpen": "ROADMAP A2",
}


@pytest.mark.parametrize("name", sorted(ONCE_UNRENDERED))
def test_unrendered_entries_raise_naming_their_item(name):
    """Once refused with NotImplementedError naming ONCE_UNRENDERED's item:
    each entry now renders at 64x48 like the oracle (float output)."""
    path, _program, _fdef = LIBRARY[name]
    f = _library_filter(name)
    n_img = sum(1 for p in f.fdef.params if p.kind == "image")
    inputs = [_image(64, 48, seed=21 + i, dtype="f32") for i in range(n_img)]
    want = mm.compile_file(path, main=name).render(*inputs, width=64, height=48, t=0.3,
                                                   interpret=True)
    got = f.render(*inputs, width=64, height=48, t=0.3, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", COMPOSITIONS)
def test_composition_uint8_output_matches_goldens(name):
    """A composition compiled by the port's default_db() (the composer's
    source, every library filter in scope) reproduces its golden."""
    with open(os.path.join(ROOT, "tests", "goldens.json")) as fh:
        goldens = json.load(fh)
    out = _goldens_render(name, mt.default_db().compile(name))
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == goldens[name]


def test_uint8_output_is_the_packed_float_output():
    port, _ = _pair("twirl")
    img = _image(64, 48, seed=4, dtype="u8")
    f = port.render(img, device="cpu").numpy()
    u = port.render(img, device="cpu",
                    options=mt.RenderOptions(output_dtype="uint8")).numpy()
    np.testing.assert_array_equal(u, np.floor(np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))


#: ROADMAP C3 (closed): twirl's `(1 - r / R) ^ 2` on a noise image, where
#: torch's CPU sqrt (the radius `r`) and pow were an ulp from the oracle's
#: float32 numpy ufuncs and the image's gradient amplified the ulp past the
#: tolerance at 2 of 65,536 values (angle 3, pixel (32, 211)) and 1 (angle 5)
@pytest.mark.parametrize("angle", [3.0, 5.0])
def test_twirl_on_a_noise_image_matches_the_oracle(angle):
    img = np.random.default_rng(7).random((64, 256, 4)).astype(np.float32)
    img[..., 3] = 1.0
    port, ref = _pair("twirl")
    want = np.asarray(ref.render(img, params={"angle": angle}, interpret=True))
    got = port.render(img, params={"angle": angle}, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["sqrt", "pow"])
def test_cpu_sqrt_and_pow_are_the_oracles_numpy_ufuncs(name):
    from mathmap_tpu_torch.ops import libm

    rng = np.random.default_rng(3)
    a = rng.random((64, 256)).astype(np.float32) * 2
    b = np.float32(2.0)
    args = (a,) if name == "sqrt" else (a, b)
    want = (np.sqrt if name == "sqrt" else np.power)(*args)
    got = getattr(libm, name)(*(torch.from_numpy(np.asarray(x)) for x in args))
    np.testing.assert_array_equal(got.numpy(), want)


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


#: language features once refused, held to the oracle
ONCE_REFUSED = {
    "quaternion": "q = quat:[1, 2, 3, 4] * quat:[1, 0, 0, 0]; rgbaColor(q[0], q[1], q[2], 1)",
}


@pytest.mark.parametrize("what", sorted(ONCE_REFUSED))
def test_unported_language_features_raise(what):
    """Once refused (ROADMAP A7): renders like the oracle."""
    src = ONCE_REFUSED[what]
    img = _image(20, 16, 0, "f32")
    got = mt.compile_source(src).render(img, device="cpu")
    want = mm.compile(src).render(img, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opts", [dict(region=(0, 0, 4, 4)),
                                  dict(supersample=2, supersample_scheme="corners")])
def test_unported_options_raise(opts):
    """Once refused (ROADMAP A4c): a region and the corners scheme render
    as the oracle's (tests/test_torch_region.py holds the rest)."""
    src = "origVal(xy + xy:[sin(y / 3), cos(x / 4)])"
    img = _image(20, 16, 0, "f32")
    got = mt.compile_source(src).render(img, device="cpu", options=mt.RenderOptions(**opts))
    want = mm.compile(src).render(img, interpret=True, options=mm.RenderOptions(**opts))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entry,item", [("render_batch", "A4"), ("render_animation", "A4")])
def test_unported_entry_points_raise(entry, item):
    """Once refused (ROADMAP A4): render_batch and render_animation of
    twirl render each job or frame as the oracle's lone render at its t
    and frame (tests/test_torch_batch.py and test_torch_animation.py hold
    the rest)."""
    port, ref = _pair("twirl")
    img = _image(20, 16, 0, "f32")
    if entry == "render_batch":
        ts = np.float32([0.1, 0.35, 0.6])
        got = port.render_batch(np.stack([img] * 3), ts=ts, device="cpu")
    else:
        ts = np.arange(3, dtype=np.float32) / 3
        got = port.render_animation(img, num_frames=3, device="cpu")
    assert got.shape == (3, 16, 20, 4)
    for i in range(3):
        want = ref.render(img, t=float(ts[i]), frame=float(i), interpret=True)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{entry} (ROADMAP {item}) job {i}")


def test_animated_input_raises():
    """Once refused (ROADMAP A4): an animated (T, H, W, 4) input renders,
    sampled at the render's frame, as the oracle does."""
    port, ref = _pair("twirl")
    stack = np.random.RandomState(3).rand(2, 16, 20, 4).astype(np.float32)
    got = port.render(stack, frame=1.0, device="cpu")
    want = ref.render(stack, frame=1.0, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
