"""The design of kernel B1 (csrc/sample_image.cu) that can be checked
without the card.

- The wrapper's choice of instantiation: V = 4 pixels a thread only when
  the row width divides by 4 and the x, y and output pointers are all
  16-byte aligned, and only for nearest and bilinear; else V = 1.
- The u8 conversion: the kernel's three operations (q = u * r with
  r = 1/255 rounded to float32, e = fma(-q, 255, u), fma(e, r, q)) give
  float(u) / 255 correctly rounded for all 256 values, proved here with
  exact rational arithmetic; the card checks the same bit for bit
  (tests/test_torch_cuda.py, chip_smoke.py).
- The C interface the wrapper binds with ctypes has the parameters the
  wrapper passes.

The wrapper's refusals stay in tests/test_torch_sampling.py.
"""

import ctypes
import importlib.util
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from mathmap_tpu_torch.kernels import build
from mathmap_tpu_torch.kernels import sample_image as K

SOURCE = (build.CSRC / "sample_image.cu").read_text()


def f32(x: Fraction) -> Fraction:
    """`x` rounded to the nearest float32, ties to even (normal and
    subnormal range), as an exact Fraction."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    m = x / quantum
    n, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and n % 2):
        n += 1
    return sign * n * quantum


INV255 = f32(Fraction(1, 255))


def kernel_unit(u: int) -> Fraction:
    """The kernel's `unit(u)`: each fused operation rounds once."""
    q = f32(u * INV255)
    e = f32(u - q * 255)
    return f32(e * INV255 + q)


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("w,offsets,aligned", [
    (28, (0, 0, 0), True),
    (3840, (0, 0, 0), True),
    (4, (16, 32, 48), True),
    (27, (0, 0, 0), False),
    (1919, (0, 0, 0), False),
    (2, (0, 0, 0), False),
    (28, (4, 0, 0), False),
    (28, (0, 8, 0), False),
    (28, (0, 0, 12), False),
    (27, (4, 4, 4), False),
])
def test_vector_width_needs_a_width_of_fours_and_aligned_pointers(w, offsets, aligned, interp):
    base = 0x7F0000000000
    want = 4 if aligned and interp != "bicubic" else 1
    assert K.vector_width(w, *(base + o for o in offsets), interp) == want


def test_vector_width_of_real_tensors():
    """A fresh tensor is aligned; a view one element into its buffer is
    not, though it is contiguous and the wrapper takes it."""
    buf = torch.zeros(20 * 28 + 1)
    aligned = buf[:-1].view(20, 28)
    offset = buf[1:].view(20, 28)
    out = torch.empty(4, 20, 28)
    assert offset.is_contiguous()
    assert K.vector_width(28, aligned.data_ptr(), aligned.data_ptr(), out.data_ptr()) == 4
    assert K.vector_width(28, offset.data_ptr(), aligned.data_ptr(), out.data_ptr()) == 1
    assert K.vector_width(28, aligned.data_ptr(), offset.data_ptr(), out.data_ptr()) == 1


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
def test_offset_views_and_ragged_widths_sample_like_aligned_copies(interp):
    """The inputs that take V = 1 on the card are sampled by the CPU route
    like their aligned copies: the layout changes no value."""
    rs = np.random.RandomState(3)
    pix = torch.from_numpy((rs.rand(12, 16, 4) * 255).astype(np.uint8))
    x = torch.from_numpy(rs.uniform(-10, 10, (5, 27)).astype(np.float32))
    y = torch.from_numpy(rs.uniform(-8, 8, (5, 27)).astype(np.float32))
    bx, by = torch.empty(x.numel() + 1), torch.empty(y.numel() + 1)
    xo, yo = bx[1:].view(5, 27), by[1:].view(5, 27)
    xo.copy_(x)
    yo.copy_(y)
    args = (interp, "wrap", "color", (0.25, 0.5, 0.75, 1.0))
    want = K.sample_image(pix, x, y, *args)
    assert torch.equal(K.sample_image(pix, xo, yo, *args), want)
    assert torch.equal(K.sample_image(pix, x[:, :24].contiguous(), y[:, :24].contiguous(), *args),
                       want[:, :, :24])


def test_rounding_helper_agrees_with_numpy():
    for v in (Fraction(1, 3), Fraction(-7, 255), Fraction(2) ** -140, Fraction(10**9, 7)):
        assert f32(v) == Fraction(float(np.float32(float(v))))


def test_u8_conversion_is_exact_for_all_256_values():
    wrong = [u for u in range(256) if kernel_unit(u) != f32(Fraction(u, 255))]
    assert wrong == []
    # and the same values as u8_to_float, the plain version's rule
    want = K.u8_to_float(torch.arange(256, dtype=torch.int32).to(torch.uint8))
    assert [Fraction(float(v)) for v in want] == [kernel_unit(u) for u in range(256)]


def test_u8_conversion_needs_its_correction():
    """u * (1/255) alone, the near miss, rounds 126 of the 256 values
    wrongly."""
    wrong = [u for u in range(256) if f32(u * INV255) != f32(Fraction(u, 255))]
    assert len(wrong) == 126


def test_kernel_source_has_the_proved_conversion():
    """The constant is 1/255 rounded to float32, and the three steps are the
    ones proved above, as round-to-nearest intrinsics nvcc cannot contract."""
    literal = re.search(r"kInv255 = (0x[0-9a-fA-Fp.+-]+)f;", SOURCE).group(1)
    assert Fraction(float.fromhex(literal)) == INV255
    body = re.search(r"float unit\(unsigned char u\) \{(.*?)\n\}", SOURCE, re.S).group(1)
    steps = [" ".join(line.split()) for line in body.strip().splitlines()]
    assert steps == ["const float a = static_cast<float>(u);",
                     "const float q = __fmul_rn(a, kInv255);",
                     "const float e = __fmaf_rn(-q, 255.0f, a);",
                     "return __fmaf_rn(e, kInv255, q);"]


def test_c_interface_matches_the_bound_argument_types():
    """The parameters of mm_sample_image, in order, against ARGTYPES: a
    pointer for each pointer, an int for each int, a float for each float."""
    params = re.search(r'extern "C" int mm_sample_image\((.*?)\)', SOURCE, re.S).group(1)
    kinds = []
    for p in " ".join(params.split()).split(","):
        p = p.strip()
        kinds.append(ctypes.c_void_p if "*" in p else
                     ctypes.c_float if p.startswith("float") else ctypes.c_int)
    assert kinds == list(K.ARGTYPES)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", build.CSRC.parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["fisheye", "twirl", "pond"])
def test_smoke_captures_the_coordinate_fields_a_render_samples(name):
    """chip_smoke.py times B1 on the coordinate fields a distortion render
    hands the sampler (runtime.sampling.sample_kernel): one call a render,
    (H, W) float32 grids, and the captured call gives the render's
    samples."""
    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.runtime import sampling

    smoke = _chip_smoke()
    f = mt.compile_file(str(build.CSRC.parent.parent / "filters" / "Distorts" / f"{name}.mm"))
    _, u8 = smoke.seeded_image(40, 24, seed=4)
    img = torch.from_numpy(u8)
    with smoke.KernelCapture(sampling, "sample_kernel") as cap:
        out = f.render(img, device="cpu")
    assert sampling.sample_kernel is K.sample_image
    assert len(cap.calls) == 1
    (pix, x, y, interp, ex, ey, col), kwargs = cap.calls[0]
    assert kwargs == {} and pix.dtype == torch.uint8 and interp == "bilinear"
    assert x.shape == y.shape == (24, 40) and x.dtype == y.dtype == torch.float32
    samples = K.sample_image(pix, x, y, interp, ex, ey, col)
    torch.testing.assert_close(samples.permute(1, 2, 0).clamp(0, 1), out, rtol=0, atol=0)


def test_smoke_reports_registers_and_spills_per_kernel():
    log = ("ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers, 8 bytes cumulative stack size\n"
           "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3barv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 22 registers, used 0 barriers\n")
    lines = _chip_smoke().ptxas_report(log)
    assert len(lines) == 2
    assert "Used 40 registers" in lines[0] and "8 bytes spill stores" in lines[0]
    assert "Used 22 registers" in lines[1] and "0 bytes spill stores" in lines[1]
