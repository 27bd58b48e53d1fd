"""Kernel B5, a frame's finish: wrapper, launch count and plain version.

The last step of every frame (runtime/render.py::render_frame) scales the
four channel planes by the supersampling weight, clamps them to [0, 1],
interleaves them into the (H, W, 4) RGBA frame and, for uint8 output,
packs them. In eager torch that is six kernels (four `plane * inv`,
`torch.stack`, `torch.clamp`), ten with the pack. The CUDA kernel
(csrc/finish_rgba.cu) does it in one pass over memory. It replaces no TPU
kernel (XLA fuses this step in the JAX package); it was added because the
eager chain was the port's largest device op and the step is bound by
bytes. `finish_rgba_reference` below is that eager chain, which the kernel
equals bit for bit, NaN, ±inf and -0.0 included.

Every frame finishes through the ops, which route by device alone: a CPU
frame (the float64 spec's too) runs the plain version, a CUDA frame the
kernel, whose launch raises on what it does not take (`_check`).

The kernel reads each plane through its strides, so a plane arrives as
the evaluator hands it over: contiguous (a sampler's or LUT's unbound
output), broadcast along a row or a column (stride 0 on one axis: a
coordinate grid) or on both (a constant channel). It writes a new frame or
`out`, an (H, W, 4) view whose pixel stride is 4 and channel stride 1 (a
batch's slice).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.trace import count
from . import build


def pack_uint8(rgba: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Device-side 8-bit packing, the reference's rule: clip to [0,1],
    ·255 + 0.5, floor. The explicit floor makes the float->int convert
    exact. `out`: a uint8 tensor to cast into."""
    x = torch.floor(torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5)
    return x.to(torch.uint8) if out is None else out.copy_(x)


def finish_rgba_reference(planes, inv: float, u8: bool,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """The eager finish: four (H, W) planes, each times `inv`, stacked
    into (H, W, 4), then clamped to [0, 1] (NaN kept), or packed to uint8
    when `u8`; written into `out` when given."""
    rgba = torch.stack([a * inv for a in planes], dim=-1)
    if u8:
        return pack_uint8(rgba, out)
    return torch.clamp(rgba, 0.0, 1.0, out=out)


def _out_matches(out: torch.Tensor, planes) -> bool:
    """Whether the kernel writes `out` for these planes: an (H, W, 4)
    uint8 or float32 tensor on their device, pixel stride 4, channel
    stride 1."""
    first, shape = planes[0], out.shape
    return (len(shape) == 3 and shape[2] == 4 and shape[:2] == first.shape
            and out.dtype in (torch.uint8, torch.float32)
            and out.get_device() == first.get_device() and out.stride(2) == 1
            and (shape[1] == 1 or out.stride(1) == 4))


def _check(planes, out: torch.Tensor) -> None:
    """The launch's one check, which guards the C call: raises ValueError
    unless `planes` are four float32 (H, W) tensors on one CUDA device and
    `out` is one the kernel writes there (`_out_matches`)."""
    index = out.get_device()
    if not (index >= 0 and len(planes) == 4 and _out_matches(out, planes)
            and all(a.dtype == torch.float32 and a.get_device() == index
                    and a.shape == out.shape[:2] for a in planes)):
        raise ValueError(
            "finish_rgba takes four float32 (H, W) planes on one CUDA device and an "
            "(H, W, 4) out of the frame's dtype there, pixel stride 4 and channel "
            f"stride 1; got planes "
            f"{[(tuple(a.shape), a.dtype, str(a.device)) for a in planes]}, out "
            f"{tuple(out.shape)} {out.dtype} {out.device} strides {out.stride()}")


def wide_stores(out_ptr: int, out_row_bytes: int, u8: bool) -> bool:
    """Whether the kernel's launch stores each pixel at once (16 bytes of
    float32 RGBA, 4 of uint8): the output's pointer (`out_ptr`) and row
    stride (`out_row_bytes`) both multiples of a pixel's bytes. Else the
    narrow instantiation stores each channel."""
    pixel = 4 if u8 else 16
    return out_ptr % pixel == 0 and out_row_bytes % pixel == 0


#: the C interface's parameters, csrc/finish_rgba.cu::mm_finish_rgba
ARGTYPES = (
    *(ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 4,  # planes, strides
    ctypes.c_void_p, ctypes.c_longlong,  # out, its row stride
    ctypes.c_int, ctypes.c_int,  # h, w
    ctypes.c_int, ctypes.c_float, ctypes.c_int,  # u8, inv, one store a pixel
    ctypes.c_void_p,  # stream
)


@functools.cache
def _kernel():
    return build.function("mm_finish_rgba", ARGTYPES)


def _launch(planes, inv: float, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream of the planes' device,
    writing `out`; raises on what it does not take."""
    _check(planes, out)
    h, w = out.shape[:2]
    if h == 0 or w == 0:
        return
    # each plane's pointer and (row, column) strides in elements
    layouts = [v for a in planes for v in (a.data_ptr(), *a.stride())]
    u8 = out.dtype == torch.uint8
    out_ptr, out_row = out.data_ptr(), out.stride(0)
    wide = wide_stores(out_ptr, out_row * out.element_size(), u8)
    with torch.cuda.device(out.get_device()):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(*layouts, out_ptr, out_row, h, w, int(u8), inv, int(wide), stream)
    build.raise_for(err, "finish_rgba")
    count("launch.finish_rgba")


torch.library.define(
    "mathmap::finish_rgba",
    "(Tensor r, Tensor g, Tensor b, Tensor a, float inv, bool u8) -> Tensor")
torch.library.define(
    "mathmap::finish_rgba_out",
    "(Tensor r, Tensor g, Tensor b, Tensor a, float inv, Tensor(a!) out) -> ()")


def _finish_cpu(r, g, b, a, inv, u8):
    return finish_rgba_reference((r, g, b, a), inv, u8)


def _finish_out_cpu(r, g, b, a, inv, out):
    finish_rgba_reference((r, g, b, a), inv, out.dtype == torch.uint8, out)


def _finish_cuda(r, g, b, a, inv, u8):
    out = torch.empty((*r.shape, 4), dtype=torch.uint8 if u8 else torch.float32,
                      device=r.device)
    _launch((r, g, b, a), inv, out)
    return out


def _finish_out_cuda(r, g, b, a, inv, out):
    _launch((r, g, b, a), inv, out)


def _finish_fake(r, g, b, a, inv, u8):
    return r.new_empty((*r.shape, 4), dtype=torch.uint8 if u8 else torch.float32)


def _finish_out_fake(r, g, b, a, inv, out):
    return None


torch.library.impl("mathmap::finish_rgba", "CPU")(_finish_cpu)
torch.library.impl("mathmap::finish_rgba", "CUDA")(_finish_cuda)
torch.library.register_fake("mathmap::finish_rgba")(_finish_fake)
torch.library.impl("mathmap::finish_rgba_out", "CPU")(_finish_out_cpu)
torch.library.impl("mathmap::finish_rgba_out", "CUDA")(_finish_out_cuda)
torch.library.register_fake("mathmap::finish_rgba_out")(_finish_out_fake)


def finish_rgba(planes, inv: float, u8: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """Finish a frame: four (H, W) planes, each times `inv`, clamped to
    [0, 1] and interleaved -> (H, W, 4) float32, or uint8 packed as
    `pack_uint8` packs when `u8`; written into `out` when given (then
    `out`'s dtype must be the frame's).

    The custom ops `mathmap::finish_rgba` (a new frame), which an exported
    program calls too, and `mathmap::finish_rgba_out`: CPU tensors go to
    the plain version (float64 planes of the float64 spec too, which then
    give a float64 frame); CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise."""
    r, g, b, a = planes
    if out is None:
        return torch.ops.mathmap.finish_rgba(r, g, b, a, inv, u8)
    if out.dtype != (torch.uint8 if u8 else torch.float32):
        raise TypeError(f"out must be {'uint8' if u8 else 'float32'}, got {out.dtype}")
    torch.ops.mathmap.finish_rgba_out(r, g, b, a, inv, out)
    return out
