"""Kernel B1, the origVal sampler: wrapper, launch count and plain version.

The CUDA kernel (csrc/sample_image.cu) replaces the JAX package's Pallas
kernel `mathmap_tpu/pallas_kernels/sample_kernel.py::sample_image_pallas`.
It computes the same thing as `sample_image_reference` below: each output
pixel's world coordinate goes to a pixel centre, the edge behavior maps each
integer tap, and the RGBA taps are interpolated (nearest, bilinear, or 4x4
Catmull-Rom bicubic) in fp32.

On the card it is bound by bytes: 8 B of coordinates and 16 B of output per
pixel, touched once, while the taps (16 B of f32 or 4 B of u8 source) mostly
hit L1/L2 for smooth warps. The kernel converts a u8 tap to u/255 exactly
in three fused operations instead of an IEEE division, samples V = 4
adjacent pixels a thread with 16-byte coordinate loads and plane stores
(`vector_width` chooses V = 1 for bicubic, a ragged width or unaligned
pointers) and edge-maps each axis once per pixel. The thread block of each
instantiation is fixed in the source; the block shapes and pixels a thread
were chosen on the card (csrc/sample_image.cu has the design note, PERF.md
the numbers).

The helpers below are the semantics the kernel mirrors tap for tap (the
port of the reference's `runtime/sampling.py` helpers): world coordinates
-> continuous pixel-centre coordinates, the edge behavior per integer tap
(wrap = floored mod, reflect = mirror with period 2n, color = clamp + an
inside mask that substitutes the edge color), and the Catmull-Rom weights.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.constants import constant
from ..utils.trace import count, span
from . import build

_LITERAL = span("mm.sync.literal")

INTERPOLATIONS = {"nearest": 0, "bilinear": 1, "bicubic": 2}
EDGES = {"color": 0, "wrap": 1, "reflect": 2}
#: int32 indexing in the kernel: a source texel's element offset
#: (row * Wi + col) * 4 must stay below 2^31
MAX_SOURCE_PIXELS = 2**31 // 4
#: pixels a thread of the vector instantiation samples
VECTOR = 4
#: the interpolations that take it (the C interface refuses bicubic at
#: V = 4): bicubic's 16 taps a pixel run faster one pixel a thread (PERF.md)
VECTOR_INTERPOLATIONS = ("nearest", "bilinear")


def vector_width(w: int, x_ptr: int, y_ptr: int, out_ptr: int,
                 interpolation: str = "bilinear") -> int:
    """Pixels per thread of the kernel's launch: VECTOR for an
    interpolation of VECTOR_INTERPOLATIONS when the row width `w` divides by
    it and the coordinate and output pointers are all 16-byte aligned (one
    float4 load or store per VECTOR pixels), else 1."""
    if (interpolation in VECTOR_INTERPOLATIONS and w % VECTOR == 0
            and all(p % 16 == 0 for p in (x_ptr, y_ptr, out_ptr))):
        return VECTOR
    return 1


def world_to_pixel(x, y, w: int, h: int):
    """World coords -> continuous pixel-center coords (px, py): one f32
    add each."""
    px = x + (w * 0.5 - 0.5)
    py = (h * 0.5 - 0.5) - y
    return px, py


def _edge_index(i, n: int, behavior: str):
    """Map an int32 sample index to a valid index + in-bounds mask.

    Returns (index in [0, n), inside): `inside` is None for wrap/reflect,
    and the out-of-bounds mask for 'color'. torch.remainder is the floored
    modulo (np.mod); torch.fmod would be wrong for negative indices."""
    if behavior == "wrap":
        return torch.remainder(i, n), None
    if behavior == "reflect":
        j = torch.remainder(i, 2 * n)
        return torch.where(j < n, j, 2 * n - 1 - j), None
    # 'color': clamp for the gather, mask decides edge-color substitution
    inside = (i >= 0) & (i < n)
    return torch.clamp(i, 0, n - 1), inside


def _tap(gather, ix, iy, w, h, edge_x, edge_y, edge_color):
    """One (possibly out-of-bounds) integer tap -> 4 channel grids with the
    edge behavior applied. `gather(iy, ix)` maps in-range indices to
    channel values."""
    jx, in_x = _edge_index(ix, w, edge_x)
    jy, in_y = _edge_index(iy, h, edge_y)
    chans = gather(jy, jx)
    inside = None
    for m in (in_x, in_y):
        if m is not None:
            inside = m if inside is None else (inside & m)
    if inside is not None:
        chans = [torch.where(inside, c, col) for c, col in zip(chans, edge_color)]
    return chans


def _catmull_rom_weights(f):
    """Catmull-Rom cubic weights for fractional offset f in [0,1): taps at
    -1, 0, +1, +2."""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


def u8_to_float(t: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] by IEEE division, the reference's
    `render.float_inputs` rule; the CUDA kernel's three fused operations
    per tap give the same values bit for bit. The divisor is a tensor on
    `t`'s device: PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead, which is 1 ulp off for some values. The
    divisor is uploaded once per device (utils/constants.py): on a card
    that first copy waits for the device's queue (a `mm.sync.literal`
    span)."""
    return t.to(torch.float32) / constant(_LITERAL, 255.0, torch.float32, t.device)


def _gather(pixels):
    """The plain sampler's gather over an (H, W, 4) image: `gather(iy, ix)`
    maps in-range int index grids to 4 float32 channel grids, one flat
    (H*W, 4) row per tap. It converts uint8 taps by u8_to_float's rule, and
    uploads its divisor outside any sync span: it stands for the card's
    kernel, which converts in its loads and waits for nothing."""
    w = int(pixels.shape[1])
    flat = pixels.reshape(-1, 4)

    def gather(iy, ix):
        g = flat[(iy * w + ix).long()]
        if g.dtype == torch.uint8:
            g = g.to(torch.float32) / torch.tensor(255.0, device=g.device)
        return [g[..., c] for c in range(4)]

    return gather


def interpolate(gather, x, y, w: int, h: int, interpolation: str, edge_x: str,
                edge_y: str, edge_color, device) -> list:
    """The plain sampler's arithmetic (the reference's oracle path
    `runtime/sampling._sample_xla`) on a frame of (w, h) pixels read
    through `gather` -> 4 float32 channel grids: world coordinates to
    pixel centres, the edge behavior per integer tap, then nearest,
    bilinear or Catmull-Rom bicubic taps (dx inner, dy outer)."""
    col = [torch.tensor(float(c), dtype=torch.float32, device=device)
           for c in edge_color]
    px, py = world_to_pixel(x, y, w, h)

    def tap(ix, iy):
        return _tap(gather, ix, iy, w, h, edge_x, edge_y, col)

    if interpolation == "nearest":
        ix = torch.floor(px + 0.5).to(torch.int32)
        iy = torch.floor(py + 0.5).to(torch.int32)
        return tap(ix, iy)

    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)

    if interpolation == "bilinear":
        c00 = tap(x0, y0)
        c10 = tap(x0 + 1, y0)
        c01 = tap(x0, y0 + 1)
        c11 = tap(x0 + 1, y0 + 1)
        out = []
        for ch in range(4):
            top = c00[ch] + fx * (c10[ch] - c00[ch])
            bot = c01[ch] + fx * (c11[ch] - c01[ch])
            out.append(top + fy * (bot - top))
        return out

    wx = _catmull_rom_weights(fx)
    wy = _catmull_rom_weights(fy)
    out = [None] * 4
    for dy in range(-1, 3):
        row = [None] * 4
        for dx in range(-1, 3):
            c = tap(x0 + dx, y0 + dy)
            wgt = wx[dx + 1]
            for ch in range(4):
                term = wgt * c[ch]
                row[ch] = term if row[ch] is None else row[ch] + term
        wgt_y = wy[dy + 1]
        for ch in range(4):
            term = wgt_y * row[ch]
            out[ch] = term if out[ch] is None else out[ch] + term
    return out


def sample_image_reference(pixels, x, y, interpolation: str, edge_x: str,
                           edge_y: str, edge_color) -> torch.Tensor:
    """The plain PyTorch sampler -> (4, H, W) float32, on the device of
    its inputs. Given float64 coordinates (the CPU's float64 spec render)
    it computes as the reference's oracle does in float64: the taps keep
    the image's dtype (a uint8 tap is u/255 in float32) and the weights
    are float64, so the result is float64 except where a float32 image's
    nearest taps are returned as they are."""
    h, w = int(pixels.shape[0]), int(pixels.shape[1])
    return torch.stack(interpolate(_gather(pixels), x, y, w, h, interpolation, edge_x,
                                   edge_y, edge_color, pixels.device))


def _check(pixels, x, y, interpolation, edge_x, edge_y, edge_color):
    if pixels.dim() != 3 or pixels.shape[2] != 4:
        raise ValueError(f"pixels must be (H, W, 4), got {tuple(pixels.shape)}")
    # the float64 spec render (interpret=True, precision="f64") samples on
    # the CPU only: the kernel is float32
    spec = pixels.device.type == "cpu" and x.dtype == torch.float64
    if pixels.dtype not in ((torch.float32, torch.uint8, torch.float64) if spec
                            else (torch.float32, torch.uint8)):
        raise TypeError(f"pixels must be float32 or uint8, got {pixels.dtype}")
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(
            f"x and y must be (H, W) grids of one shape, got "
            f"{tuple(x.shape)} and {tuple(y.shape)}")
    if y.dtype != x.dtype or not (x.dtype == torch.float32 or spec):
        raise TypeError(f"x and y must be float32 (float64 on the CPU), got "
                        f"{x.dtype}, {y.dtype}")
    if not (x.device == y.device == pixels.device):
        raise ValueError(
            f"pixels, x and y must share a device, got {pixels.device}, "
            f"{x.device}, {y.device}")
    if not (pixels.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pixels, x and y must be contiguous")
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation must be one of {tuple(INTERPOLATIONS)}")
    if edge_x not in EDGES or edge_y not in EDGES:
        raise ValueError(f"edge behaviors must be one of {tuple(EDGES)}")
    if len(edge_color) != 4:
        raise ValueError("edge_color needs 4 components")
    if pixels.shape[0] * pixels.shape[1] >= MAX_SOURCE_PIXELS:
        raise ValueError(
            f"source image of {pixels.shape[0]}x{pixels.shape[1]} pixels "
            f"exceeds the kernel's int32 indexing ({MAX_SOURCE_PIXELS})")


#: the C interface's parameters, csrc/sample_image.cu::mm_sample_image
ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pixels
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, y, out
    ctypes.c_int, ctypes.c_int,  # h, w
    ctypes.c_int,  # pixels a thread
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # interp, edge_x, edge_y
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,  # stream
)


@functools.cache
def _kernel():
    return build.function("mm_sample_image", ARGTYPES)


torch.library.define(
    "mathmap::sample_image",
    "(Tensor pixels, Tensor x, Tensor y, str interpolation, str edge_x, str edge_y, "
    "float[] edge_color) -> Tensor")


def _sample_image_cpu(pixels, x, y, interpolation, edge_x, edge_y, edge_color):
    return sample_image_reference(pixels, x, y, interpolation, edge_x, edge_y,
                                  edge_color).contiguous()


torch.library.impl("mathmap::sample_image", "CPU")(_sample_image_cpu)


def _sample_image_cuda(pixels, x, y, interpolation, edge_x, edge_y, edge_color):
    _check(pixels, x, y, interpolation, edge_x, edge_y, edge_color)
    h, w = int(x.shape[0]), int(x.shape[1])
    out = torch.empty((4, h, w), dtype=torch.float32, device=pixels.device)
    if out.numel() == 0:
        return out
    align = 16 if pixels.dtype == torch.float32 else 4
    if pixels.data_ptr() % align:
        raise ValueError(f"pixels must be {align}-byte aligned for vector loads")
    kernel = _kernel()
    vec = vector_width(w, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                       interpolation)
    with torch.cuda.device(pixels.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(pixels.data_ptr(), int(pixels.dtype == torch.uint8),
                     int(pixels.shape[0]), int(pixels.shape[1]),
                     x.data_ptr(), y.data_ptr(), out.data_ptr(), h, w, vec,
                     INTERPOLATIONS[interpolation], EDGES[edge_x],
                     EDGES[edge_y], *(float(c) for c in edge_color), stream)
    build.raise_for(err, "sample_image")
    count("launch.sample_image")
    return out


torch.library.impl("mathmap::sample_image", "CUDA")(_sample_image_cuda)


def _sample_image_fake(pixels, x, y, interpolation, edge_x, edge_y, edge_color):
    return x.new_empty((4, *x.shape))


torch.library.register_fake("mathmap::sample_image")(_sample_image_fake)


def sample_image(pixels, x, y, interpolation: str, edge_x: str, edge_y: str,
                 edge_color) -> torch.Tensor:
    """Sample `pixels` ((Hi, Wi, 4) float32 or uint8) at world coordinate
    grids `x`, `y` ((H, W) float32) -> planar (4, H, W) float32. On the
    CPU, float64 coordinates (and float64 pixels) take the plain version's
    float64 path, the reference's float64 spec.

    The custom op `mathmap::sample_image`, which an exported program
    (generators/artifact.py) calls too: a CPU tensor goes to the plain
    version; a CUDA tensor launches the kernel on the current stream (no
    synchronisation) or raises."""
    _check(pixels, x, y, interpolation, edge_x, edge_y, edge_color)
    if pixels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sampler for device {pixels.device}")
    return torch.ops.mathmap.sample_image(pixels, x, y, interpolation, edge_x, edge_y,
                                          [float(c) for c in edge_color])

