"""Tests that need the card: the CUDA sampler kernel against its plain
PyTorch version, and renders on the GPU against the port's CPU renders.

They carry the `cuda` marker and skip without a GPU. This file imports only
torch, numpy and the port, so it also runs on a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import os

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.kernels import sample_image as K

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(__file__), "..")
HI, WI = 24, 32  # source image, non-square
H, W = 20, 28  # coordinate grid
RTOL, ATOL = 1e-4, 1e-5
INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _source(dtype):
    f32 = np.random.RandomState(5).rand(HI, WI, 4).astype(np.float32)
    if dtype == "u8":
        return np.floor(f32 * 255 + 0.5).astype(np.uint8)
    return f32


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


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("ex,ey", EDGE_PAIRS)
@pytest.mark.parametrize("interp", INTERPOLATIONS)
def test_cuda_kernel_matches_plain_version(cuda, interp, ex, ey, dtype):
    pix = torch.from_numpy(_source(dtype)).to(cuda)
    x, y = (torch.from_numpy(a).to(cuda) for a in _coords())
    before = K.sample_image.launches
    got = K.sample_image(pix, x, y, interp, ex, ey, EDGE_COLOR)
    want = K.sample_image_reference(pix, x, y, interp, ex, ey, EDGE_COLOR)
    torch.cuda.synchronize()
    assert K.sample_image.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _smooth_image(w, h):
    """A seeded 4x3 grid of colors, bilinearly interpolated and faded to the
    edge color at the border: the card's and the CPU's libm differ by a few
    ulp in the warp's coordinates, and a smooth image keeps that far below
    the tolerance (a noise image would amplify it)."""
    coarse = np.random.RandomState(7).rand(4, 5, 4)
    v = (np.arange(h) + 0.5) * (3 / h)
    u = (np.arange(w) + 0.5) * (4 / w)
    iv, iu = np.floor(v).astype(int), np.floor(u).astype(int)
    fv, fu = (v - iv)[:, None, None], (u - iu)[None, :, None]
    rows = coarse[iv] * (1 - fv) + coarse[iv + 1] * fv
    img = rows[:, iu] * (1 - fu) + rows[:, iu + 1] * fu
    window = (np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None, None]
              * np.sin(np.pi * (np.arange(w) + 0.5) / w)[None, :, None])
    return (img * window).astype(np.float32)


@pytest.mark.parametrize("name", ["fisheye", "twirl", "pond"])
def test_cuda_render_goes_through_the_kernel(cuda, name):
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", f"{name}.mm"))
    img = _smooth_image(64, 48)
    before = K.sample_image.launches
    got = f.render(img, t=0.3, device=cuda)
    torch.cuda.synchronize()
    assert K.sample_image.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (48, 64, 4)
    want = f.render(img, t=0.3, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
