"""Kernel B5, a frame's finish (`mathmap_tpu_torch/kernels/finish_rgba.py`),
on the CPU: its plain version and its ops' CPU implementations against the
eager expression `runtime/render.py::render_frame` finished every frame
with before B5 (four `plane * inv`, `torch.stack`, then `torch.clamp` or
`pack_uint8`), bit for bit over the plane layouts a frame hands over, the
supersampling weights, both output dtypes, `out` given or not, and NaN,
±inf and -0.0; the launch's one check (`_check`, on fake CUDA tensors)
and its instantiation (`wide_stores`); renders, batches, the corners
scheme and the float64 spec, each frame one `finish_rgba` call; and an
exported artifact that holds `mathmap::finish_rgba`. The kernel itself
runs on the card only (tests/test_torch_cuda.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
from mathmap_tpu_torch.kernels import finish_rgba as B5
from mathmap_tpu_torch.utils.trace import snapshot, since

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
H, W = 6, 12
#: values every plane holds somewhere: NaN, ±inf, signed zeros, the clamp's
#: ends and either side of them, and the uint8 pack's rounding edges
SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1e-8, 1 + 1e-7, 0.5 / 255,
                     1.5 / 255, 127.5 / 255, 254.5 / 255, 3e38, -3e38], np.float32)


def _values(shape, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    v = rs.uniform(-0.5, 1.5, shape).astype(np.float32).reshape(-1)
    at = rs.choice(v.size, min(v.size, len(SPECIALS)), replace=False)
    v[at] = SPECIALS[:len(at)]
    return torch.from_numpy(v.reshape(shape))


def _plane(layout: str, seed: int) -> torch.Tensor:
    """An (H, W) float32 plane as the evaluator may hand it over."""
    if layout == "contiguous":
        return _values((H, W), seed)
    if layout == "scalar":  # a constant channel: Evaluator.grid of a 0-d tensor
        return torch.broadcast_to(_values((1,), seed)[0], (H, W))
    if layout == "row":  # the x grid: one row repeated, stride 0 between rows
        return torch.broadcast_to(_values((W,), seed)[None, :], (H, W))
    if layout == "column":  # the y grid: stride 0 along the row
        return torch.broadcast_to(_values((H,), seed)[:, None], (H, W))
    if layout == "view":  # a non-contiguous view
        return _values((W, H), seed).t()
    raise ValueError(layout)


#: each case's four plane layouts; "mixed" is moire's (three planes and a
#: constant alpha) with a coordinate grid of each kind
LAYOUTS = {name: (name,) * 4 for name in ("contiguous", "scalar", "row", "column", "view")}
LAYOUTS["mixed"] = ("contiguous", "row", "column", "scalar")


def _eager(planes, inv: float, u8: bool) -> torch.Tensor:
    """What render_frame computed before kernel B5, written out."""
    rgba = torch.stack([a * inv for a in planes], dim=-1)
    if u8:
        return torch.floor(torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return torch.clamp(rgba, 0.0, 1.0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("out_kind", ["new", "given", "batch_slice"])
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("supersample", [1, 2, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_version_and_cpu_ops_equal_the_eager_finish(layout, supersample, u8, out_kind):
    planes = [_plane(kind, seed) for seed, kind in enumerate(LAYOUTS[layout])]
    inv = 1.0 / (supersample * supersample)
    want = _eager(planes, inv, u8)
    dtype = torch.uint8 if u8 else torch.float32
    for finish in (B5.finish_rgba_reference, B5.finish_rgba):
        if out_kind == "new":
            got = finish(planes, inv, u8)
        else:
            batch = torch.full((3, H, W, 4), 7, dtype=dtype)
            out = batch[1] if out_kind == "batch_slice" else torch.empty((H, W, 4), dtype=dtype)
            got = finish(planes, inv, u8, out)
            assert got.data_ptr() == out.data_ptr()
            if out_kind == "batch_slice":  # the other jobs' slices untouched
                assert bool((batch[0] == 7).all()) and bool((batch[2] == 7).all())
        assert _same_bits(got, want), (finish.__name__, layout, supersample, u8, out_kind)


def test_the_values_cover_nan_infinities_and_signed_zero():
    """The cases above hold every special value in every plane layout
    that stores values per pixel, and NaN survives the float32 finish."""
    for kind in ("contiguous", "view"):
        v = _plane(kind, 0).numpy()
        assert np.isnan(v).any() and np.isposinf(v).any() and np.isneginf(v).any()
        assert (np.signbit(v) & (v == 0)).any()
    got = B5.finish_rgba([_plane("contiguous", s) for s in range(4)], 1.0, False)
    assert bool(torch.isnan(got).any())


def test_a_wrong_out_dtype_raises():
    planes = [_plane("contiguous", s) for s in range(4)]
    with pytest.raises(TypeError, match="out must be uint8"):
        B5.finish_rgba(planes, 1.0, True, torch.empty((H, W, 4)))


def _empty(dev, *shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=dev)


def _four(dev):
    return [_empty(dev, H, W) for _ in range(4)]


def _broadcast(dev):
    """moire's layouts: a contiguous plane, a row, a column, a constant
    (views without indexing, which fake CUDA tensors do not take here)."""
    return [_empty(dev, H, W), torch.broadcast_to(_empty(dev, 1, W), (H, W)),
            torch.broadcast_to(_empty(dev, H, 1), (H, W)), _empty(dev).expand(H, W)]


#: (planes, u8, out) on a device -> whether the launch takes them; out None
#: is the new frame the op allocates
ROUTES = {
    "contiguous": (_four, False, None, True),
    "broadcast": (_broadcast, True, None, True),
    "out": (_four, False, lambda d: _empty(d, H, W, 4), True),
    "u8 out": (_four, True, lambda d: _empty(d, H, W, 4, dtype=torch.uint8), True),
    "batch slice": (_four, False, lambda d: _empty(d, 2, H, W, 4).select(0, 1), True),
    "float64 plane": (lambda d: _four(d)[:3] + [_empty(d, H, W, dtype=torch.float64)], False,
                      None, False),
    "three planes": (lambda d: _four(d)[:3], False, None, False),
    "out dtype": (_four, False, lambda d: _empty(d, H, W, 4, dtype=torch.float64), False),
    "out planar": (_four, False, lambda d: _empty(d, 4, H, W).permute(1, 2, 0), False),
    "out shape": (_four, False, lambda d: _empty(d, H, W, 3), False),
}


def _launch_checks(planes, out) -> bool:
    try:
        B5._check(planes, out)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_takes_routes_what_the_kernel_writes(case):
    """The launch's one check, which guards the C call, on fake CUDA
    tensors: it passes what the kernel writes and refuses the rest; the
    same planes and out on the CPU it always refuses."""
    planes, u8, out, expected = ROUTES[case]
    for dev, want in (("cuda", expected), ("cpu", False)):
        with FakeTensorMode():
            ps = planes(dev)
            o = (_empty(dev, H, W, 4, dtype=torch.uint8 if u8 else torch.float32)
                 if out is None else out(dev))
            assert _launch_checks(ps, o) is want, dev


@pytest.mark.parametrize("case", ["other shape", "out shape", "out planar"])
def test_the_launch_raises_on_what_the_kernel_does_not_take(case):
    with FakeTensorMode():
        planes, out = _four("cuda"), _empty("cuda", H, W, 4)
        if case == "other shape":
            planes[3] = _empty("cuda", H, W + 1)
        elif case == "out shape":
            out = _empty("cuda", H, W + 1, 4)
        else:
            out = _empty("cuda", 4, H, W).permute(1, 2, 0)
        with pytest.raises(ValueError, match="finish_rgba takes"):
            B5._launch(planes, 1.0, out)


def _wide(out: torch.Tensor) -> bool:
    return B5.wide_stores(out.data_ptr(), out.stride(0) * out.element_size(),
                          out.dtype == torch.uint8)


def _offset(dtype, n: int) -> torch.Tensor:
    """An (H, W, 4) output `n` elements into a buffer of its own."""
    return torch.empty(H * W * 4 + n, dtype=dtype)[n:].view(H, W, 4)


#: an output -> whether the launch stores a pixel at once (16 bytes of
#: float32, 4 of uint8), which takes pixels and rows aligned to that
WIDE_CASES = {
    "f32": (lambda: torch.empty((H, W, 4)), True),
    "u8": (lambda: torch.empty((H, W, 4), dtype=torch.uint8), True),
    "f32 batch slice": (lambda: torch.empty((3, H, W, 4))[2], True),
    "u8 batch slice": (lambda: torch.empty((3, H, W + 1, 4), dtype=torch.uint8)[1], True),
    "f32 one pixel in": (lambda: _offset(torch.float32, 4), True),
    "f32 one element in": (lambda: _offset(torch.float32, 1), False),
    "u8 one pixel in": (lambda: _offset(torch.uint8, 4), True),
    "u8 one element in": (lambda: _offset(torch.uint8, 1), False),
    "f32 rows off 16 bytes": (lambda: torch.empty(H * (4 * W + 1)).as_strided(
        (H, W, 4), (4 * W + 1, 4, 1)), False),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_stores_take_aligned_pixels_and_rows(case):
    out, wide = WIDE_CASES[case]
    assert _wide(out()) is wide


DISTORTS = ("fisheye", "twirl", "pond")


def _image(seed: int = 3):
    return np.random.RandomState(seed).rand(18, 26, 4).astype(np.float32)


def _finish_calls(monkeypatch) -> list:
    """Spy on render_frame's finish: each call's (planes, inv, u8, out)."""
    calls = []
    real = B5.finish_rgba

    def spy(planes, inv, u8, out=None):
        calls.append((planes, inv, u8, out))
        return real(planes, inv, u8, out)

    monkeypatch.setattr(B5, "finish_rgba", spy)
    return calls


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("supersample", [1, 2])
@pytest.mark.parametrize("name", DISTORTS)
def test_the_kernel_route_renders_as_the_eager_route(name, supersample, output_dtype,
                                                     monkeypatch):
    """A render and a batch finish each frame in one call of B5's
    `finish_rgba` (on the CPU its ops' plain version), the batch's into its
    slices, and each frame equals `finish_rgba_reference` of the same
    planes bit for bit; the CPU counts no launch."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", f"{name}.mm"))
    opts = mt.RenderOptions(supersample=supersample, output_dtype=output_dtype)
    img = _image()
    calls = _finish_calls(monkeypatch)
    before = snapshot()
    got = f.render(img, options=opts, device="cpu")
    got_batch = f.render_batch(img[None].repeat(3, 0), options=opts, device="cpu")
    assert "launch.finish_rgba" not in since(before)["counters"]
    inv, u8 = 1.0 / supersample ** 2, output_dtype == "uint8"
    assert [c[1:3] + (c[3] is not None,) for c in calls] == \
        [(inv, u8, False)] + [(inv, u8, True)] * 3
    for (planes, *_), frame in zip(calls, [got, *got_batch]):
        assert _same_bits(frame, B5.finish_rgba_reference(planes, inv, u8))


@pytest.mark.parametrize("case", ["corners", "float64 spec"])
def test_corners_and_the_float64_spec_finish_through_finish_rgba(case, monkeypatch):
    """The corners scheme hands `finish_rgba` its five samples' sum with
    inv = 0.2, which gives the bits of the sum times 0.2, clamped, that it
    finished with before; the float64 spec hands it float64 planes and
    gets its float64 frame from the plain version, as the eager chain."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    calls = _finish_calls(monkeypatch)
    if case == "corners":
        got = f.render(_image(), device="cpu", options=mt.RenderOptions(
            supersample=2, supersample_scheme="corners"))
    else:
        got = f.render(_image(), interpret=True, precision="f64")
    (planes, inv, u8, out), = calls
    assert (inv, u8, out) == ((0.2, False, None) if case == "corners" else (1.0, False, None))
    if case == "corners":
        assert got.dtype == torch.float32
        want = torch.clamp(torch.stack(planes, dim=-1) * 0.2, 0.0, 1.0)
    else:
        assert got.dtype == torch.float64 and all(a.dtype == torch.float64 for a in planes)
        want = _eager(planes, 1.0, False)
    assert _same_bits(got, want)


def test_an_artifact_holds_the_finish_op_and_renders_equal(tmp_path):
    """Exported on the CPU, the frame program calls
    `mathmap::finish_rgba` (its fake implementation traced it); the
    artifact saves, loads (in this process, and in a fresh one that
    imports only what load_artifact imports) and renders equal to the live
    render bit for bit, for new param values too."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    img = _image()
    h, w = img.shape[:2]
    path = tmp_path / "twirl.mmxa"
    export_artifact(f, str(path), w, h, params={"angle": 2.0}, device="cpu")
    art = load_artifact(str(path))
    targets = {str(n.target) for n in art._program.graph.nodes}
    assert "mathmap.finish_rgba.default" in targets
    assert not any("stack" in t for t in targets)
    for angle in (2.0, 3.5):
        assert _same_bits(art.render(img, params={"angle": angle}),
                          f.render(img, params={"angle": angle}, device="cpu"))
    np.save(tmp_path / "img.npy", img)
    code = f"""
import numpy as np
from mathmap_tpu_torch.generators.artifact import load_artifact
art = load_artifact({str(path)!r})
out = art.render(np.load({str(tmp_path / "img.npy")!r}), params={{"angle": 3.5}})
np.save({str(tmp_path / "out.npy")!r}, out.numpy())
"""
    env = dict(os.environ, MMTPU_PLATFORM="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = torch.from_numpy(np.load(tmp_path / "out.npy"))
    assert _same_bits(got, f.render(img, params={"angle": 3.5}, device="cpu"))
