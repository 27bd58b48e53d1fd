"""Kernel B1's plain version against the reference's plain sampler, and the
wrapper's contract.

`sample_image_reference` (the CPU route of the port's sampler) is held
against the reference's `runtime/sampling._sample_xla` on its NumPy oracle
path — the plain reference of the Pallas kernel — for every interpolation x
edge pair x source dtype, on a non-square image, at rtol=1e-4, atol=1e-5.
The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from mathmap_tpu.runtime import sampling as ref_sampling
from mathmap_tpu.runtime.options import RenderOptions as RefOptions
from mathmap_tpu.runtime.tracer import Evaluator as RefEvaluator
from mathmap_tpu.runtime.tracer import RenderContext as RefContext
from mathmap_tpu.runtime.value import InputImage as RefInputImage
from mathmap_tpu_torch.kernels import build
from mathmap_tpu_torch.kernels import sample_image as K
from mathmap_tpu_torch.utils.trace import counter

HI, WI = 24, 32  # source image, non-square
H, W = 20, 28  # coordinate grid
RTOL, ATOL = 1e-4, 1e-5
INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)
CASES = [(i, ex, ey, d) for i in INTERPOLATIONS for ex, ey in EDGE_PAIRS
         for d in ("f32", "u8")]


def _source(dtype):
    f32 = np.random.RandomState(5).rand(HI, WI, 4).astype(np.float32)
    if dtype == "u8":
        u8 = np.floor(f32 * 255 + 0.5).astype(np.uint8)
        return u8, u8.astype(np.float32) / np.float32(255.0)
    return f32, f32


def _coords():
    """World coordinates in four row bands: in range, exact texel centres,
    far outside (±3·W), and within 3 px of an edge."""
    rs = np.random.RandomState(6)
    x = np.empty((H, W), np.float32)
    y = np.empty((H, W), np.float32)
    b = np.array_split(np.arange(H), 4)
    x[b[0]] = rs.uniform(-WI / 2, WI / 2, (len(b[0]), W))
    y[b[0]] = rs.uniform(-HI / 2, HI / 2, (len(b[0]), W))
    x[b[1]] = rs.randint(0, WI, (len(b[1]), W)) + 0.5 - WI / 2
    y[b[1]] = HI / 2 - 0.5 - rs.randint(0, HI, (len(b[1]), W))
    x[b[2]] = rs.uniform(-3 * WI, 3 * WI, (len(b[2]), W))
    y[b[2]] = rs.uniform(-3 * WI, 3 * WI, (len(b[2]), W))
    x[b[3]] = rs.choice([-WI / 2, WI / 2], (len(b[3]), W)) + rs.uniform(-3, 3, (len(b[3]), W))
    y[b[3]] = rs.choice([-HI / 2, HI / 2], (len(b[3]), W)) + rs.uniform(-3, 3, (len(b[3]), W))
    return x, y


def _reference(interp, ex, ey, pixels_f32, x, y):
    opts = RefOptions(interpolation=interp, edge_x=ex, edge_y=ey, edge_color=EDGE_COLOR)
    ctx = RefContext(be=np, width=W, height=H, opts=opts, is_jax=False, dtype=np.float32)
    ev = RefEvaluator(ctx, x, y, {})
    out = ref_sampling._sample_xla(ev, RefInputImage(pixels=pixels_f32), x, y)
    return np.stack([np.broadcast_to(c, (H, W)) for c in out])


@pytest.mark.parametrize("interp,ex,ey,dtype", CASES)
def test_plain_sampler_matches_reference(interp, ex, ey, dtype):
    src, src_f32 = _source(dtype)
    x, y = _coords()
    before = counter("launch.sample_image")
    got = K.sample_image(torch.from_numpy(src), torch.from_numpy(x), torch.from_numpy(y),
                         interp, ex, ey, EDGE_COLOR)
    assert counter("launch.sample_image") == before  # CPU tensors never launch
    assert got.shape == (4, H, W) and got.dtype == torch.float32
    want = _reference(interp, ex, ey, src_f32, x, y)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_u8_and_f32_sources_sample_identically():
    """A u8 source converts each tap by /255, the same values as a float32
    upload of u8/255 (the reference's float_inputs rule)."""
    u8, f32 = _source("u8")
    x, y = (torch.from_numpy(a) for a in _coords())
    a = K.sample_image(torch.from_numpy(u8), x, y, "bicubic", "wrap", "reflect", EDGE_COLOR)
    b = K.sample_image(torch.from_numpy(f32), x, y, "bicubic", "wrap", "reflect", EDGE_COLOR)
    assert torch.equal(a, b)


def test_identity_sampling_reproduces_the_image():
    src, _ = _source("f32")
    xs = torch.arange(WI, dtype=torch.float32) + 0.5 - WI / 2
    ys = HI / 2 - (torch.arange(HI, dtype=torch.float32) + 0.5)
    x, y = (t.contiguous() for t in torch.meshgrid(xs, ys, indexing="xy"))
    for interp in INTERPOLATIONS:
        out = K.sample_image(torch.from_numpy(src), x, y, interp, "color", "color", EDGE_COLOR)
        np.testing.assert_allclose(out.permute(1, 2, 0).numpy(), src, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "coords", "interp",
                                 "edge", "edge_color", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src = torch.zeros(HI, WI, 4)
    x = torch.zeros(H, W)
    y = torch.zeros(H, W)
    args = dict(pixels=src, x=x, y=y, interpolation="bilinear", edge_x="color",
                edge_y="color", edge_color=EDGE_COLOR)
    if bad == "dtype":
        args["pixels"] = src.double()
    elif bad == "shape":
        args["pixels"] = torch.zeros(HI, WI, 3)
    elif bad == "contiguous":
        args["x"] = torch.zeros(W, H).t()
    elif bad == "coords":
        args["y"] = torch.zeros(H, W + 1)
    elif bad == "interp":
        args["interpolation"] = "lanczos"
    elif bad == "edge":
        args["edge_y"] = "clamp"
    elif bad == "edge_color":
        args["edge_color"] = (0.0, 0.0)
    elif bad == "device":
        args["pixels"] = torch.zeros(HI, WI, 4, device="meta")
    with pytest.raises((ValueError, TypeError)):
        K.sample_image(**args)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_library_name_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    first = build._digest([a])
    a.write_text("// two")
    assert build._digest([a]) != first
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "apply_lut.cu", "sample_image.cu", "sample_tiled.cu"]
    # the shared header is part of the library's name, so editing it rebuilds
    header = build.CSRC / "sampler_common.cuh"
    assert header.exists()
    assert build._digest([a, header]) != build._digest([a])
