"""Kernel B2, curve and gradient application: wrapper, launch count and
plain version.

The CUDA kernel (csrc/apply_lut.cu) replaces the JAX package's Pallas route
`mathmap_tpu/pallas_kernels/sample_kernel.py::apply_lut_pallas`, which ran
the LUT through the TPU sampler as a 1-row image. It computes what the
reference's oracle computes, `ops/color_ops.py::_lut_take`, ported below as
`apply_lut_reference`: clamp the position to [0, 1], scale by K-1, and
interpolate linearly between the two adjacent LUT rows.

On the card it is bound by memory: 4 B of position read and 4 B (curve) or
16 B (gradient) written per pixel, the LUT staged in shared memory. It is a
simple grid-stride pass, one thread per pixel per step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.trace import count
from . import build


def apply_lut_reference(lut: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The plain LUT application (the port of the reference's `_lut_take`):
    a (K,) or (K, C) float32 `lut` at positions `pos` (any shape) ->
    (C, *pos.shape) float32 on `pos`'s device, C = 1 for a (K,) LUT. The
    index is clamped into [0, K-1] after the float -> int conversion, so a
    NaN position reads row 0 and yields NaN. At float64 positions the
    rows' difference stays float32 and the result is float64, as in the
    oracle's float64 spec."""
    k = int(lut.shape[0])
    table = lut.reshape(k, -1)
    xf = torch.clamp(pos, 0.0, 1.0) * (k - 1)
    i0f = torch.floor(xf)
    frac = xf - i0f
    i0 = torch.clamp(i0f.to(torch.int64), 0, k - 1)
    i1 = torch.clamp(i0 + 1, max=k - 1)
    v0 = table[i0]
    v1 = table[i1]
    v = v0 + frac[..., None] * (v1 - v0)
    return v.movedim(-1, 0)


def _check(lut, pos):
    if lut.dim() not in (1, 2) or (lut.dim() == 2 and lut.shape[1] not in (1, 4)):
        raise ValueError(f"lut must be (K,) or (K, 4), got {tuple(lut.shape)}")
    if lut.shape[0] < 1:
        raise ValueError("lut needs at least one row")
    # float64 positions: the CPU's float64 spec render, where the float32
    # LUT is interpolated at them as in the reference's oracle
    spec = pos.device.type == "cpu" and pos.dtype == torch.float64
    if lut.dtype != torch.float32 or not (pos.dtype == torch.float32 or spec):
        raise TypeError(f"lut and pos must be float32 (pos float64 on the CPU), got "
                        f"{lut.dtype}, {pos.dtype}")
    if lut.device != pos.device:
        raise ValueError(f"lut and pos must share a device, got {lut.device}, {pos.device}")


@functools.cache
def _kernel():
    fn = build.library().cdll.mm_apply_lut
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # lut, k, channels
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # pos, out, n
                   ctypes.c_void_p]  # stream
    fn.restype = ctypes.c_int
    return fn


torch.library.define("mathmap::apply_lut", "(Tensor lut, Tensor pos) -> Tensor")


def _apply_lut_cpu(lut, pos):
    return apply_lut_reference(lut, pos).contiguous()


torch.library.impl("mathmap::apply_lut", "CPU")(_apply_lut_cpu)


def _apply_lut_cuda(lut, pos):
    _check(lut, pos)
    if not pos.is_contiguous():
        raise ValueError("pos must be contiguous")
    k = int(lut.shape[0])
    channels = 1 if lut.dim() == 1 else int(lut.shape[1])
    table = lut.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()
    out = torch.empty((channels, *pos.shape), dtype=torch.float32, device=pos.device)
    if pos.numel() == 0:
        return out
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(table.data_ptr(), k, channels, pos.data_ptr(),
                        out.data_ptr(), pos.numel(), stream)
    if err != 0:
        raise RuntimeError(
            f"apply_lut kernel launch failed: cudaError {err} "
            f"({build.error_string(err)})")
    count("launch.apply_lut")
    return out


torch.library.impl("mathmap::apply_lut", "CUDA")(_apply_lut_cuda)


def _apply_lut_fake(lut, pos):
    channels = 1 if lut.dim() == 1 else int(lut.shape[1])
    return pos.new_empty((channels, *pos.shape))


torch.library.register_fake("mathmap::apply_lut")(_apply_lut_fake)


def apply_lut(lut: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Apply a (K,) curve or (K, 4) gradient LUT at `pos` -> planar
    (C, *pos.shape) float32, C = 1 or 4 (float64 at the float64 positions
    of a CPU spec render).

    The custom op `mathmap::apply_lut`, which an exported program calls
    too: a CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel on the current stream (no synchronisation) or raises. The kernel
    takes `pos` contiguous; the LUT is copied when it is not contiguous and
    16-byte aligned (it is at most a few KB)."""
    _check(lut, pos)
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LUT kernel for device {pos.device}")
    return torch.ops.mathmap.apply_lut(lut, pos)

