"""Kernel B4, the origVal sampler of one tile of the input-sharded renderer:
wrapper, launch count and plain version.

The CUDA kernel (csrc/sample_tiled.cu) replaces the JAX package's
`mathmap_tpu/runtime/sampling.py::_sample_pallas_tiled`, the route that
sends a tile's halo-extended block (parallel/halo.py) through the Pallas
sampler. It does not copy that route's TPU recipe (pre-mapped coordinates
and "clamp" aprons on a padded copy); it computes what the reference's
exact gather route computes (`_sample_xla` with
`value.TiledInput.make_gather`), which `sample_tiled_reference` below
ports: world coordinates go to pixel centres of the GLOBAL frame, each
integer tap is edge-mapped globally, localised to the block
(`localize_period`) and clamped into it, and the taps are interpolated as
in kernel B1. It needs no thin-halo fallback: a tap's edge map is global,
so every halo width gives the gather's values.

It also measures the bounded-displacement contract: the excess, how far
past the block the furthest tap reached (floored mod the global period;
<= 0 when every tap stayed inside), over every tap, including those the
color edge replaces. The tiled renderer raises when it is positive.

On the card it is bound by memory: 8 B of coordinates in and 16 B out per
pixel, and the f32 block read about once. One thread per output pixel, one
16-byte load per tap, a warp-wide max and one atomic per warp for the
excess.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.trace import count
from . import build
from .sample_image import EDGES, INTERPOLATIONS, MAX_SOURCE_PIXELS, interpolate

#: the excess of a sampler no tap reached (the reference's initial value)
NO_EXCESS = -(2 ** 30)


def localize_period(g, base: int, n: int, ext_n: int):
    """Local position on a halo-extended block of a globally edge-mapped
    tap index `g` (the reference's `value.localize_period`): the plain
    shift g - base, moved by one global period n only when that shift is
    outside [0, ext_n) AND a true period overflow. Wrap-seam taps land on
    the ring-wrapped halo (tile 0 with base = -halo sees global n - 1 as
    local halo - 1); in-contract taps stay a plain shift; a below-block
    contract violation (shift in [ext_n, n)) stays large, so the caller's
    clamp lands it on the block's last row, not on a repainted lead
    halo."""
    l0 = g - base
    return torch.where(l0 < 0, l0 + n,
                       torch.where((l0 >= ext_n) & (l0 >= n), l0 - n, l0))


def _tiled_gather(ext, gh: int, gw: int, row_base: int, col_base: int,
                  col_sharded: bool, excess: list):
    """`gather(jy, jx)` over the block for globally edge-mapped indices
    (the reference's TiledInput.make_gather); appends each tap's excess to
    `excess`."""
    ext_h, ext_w = int(ext.shape[0]), int(ext.shape[1])
    flat = ext.reshape(-1, 4)

    def gather(iy, ix):
        ly = torch.clamp(localize_period(iy, row_base, gh, ext_h), 0, ext_h - 1)
        e = (torch.remainder(iy - row_base, gh) - (ext_h - 1)).max()
        if col_sharded:
            lx = torch.clamp(localize_period(ix, col_base, gw, ext_w), 0, ext_w - 1)
            e = torch.maximum(e, (torch.remainder(ix - col_base, gw) - (ext_w - 1)).max())
        else:
            lx = ix
        excess.append(e)
        g = flat[(ly * ext_w + lx).long()]
        return [g[..., c] for c in range(4)]

    return gather


def sample_tiled_reference(ext, x, y, gh: int, gw: int, row_base: int,
                           col_base: int, col_sharded: bool, interpolation: str,
                           edge_x: str, edge_y: str, edge_color):
    """The plain PyTorch version -> ((4, H, W) float32, 0-d int32 excess),
    on the device of its inputs. `ext`: the (ext_h, ext_w, 4) float32
    block; (gh, gw): the global frame (gw == ext_w when the columns are not
    split); (row_base, col_base): the global row/col of local (0, 0)."""
    excess = [torch.tensor(NO_EXCESS, dtype=torch.int32, device=ext.device)]
    if x.numel() == 0:
        out = torch.empty((4, *x.shape), dtype=torch.float32, device=ext.device)
        return out, excess[0]
    gather = _tiled_gather(ext, gh, gw, row_base, col_base, col_sharded, excess)
    out = torch.stack(interpolate(gather, x, y, gw, gh, interpolation, edge_x, edge_y,
                                  edge_color, ext.device))
    return out, torch.stack(excess).max().to(torch.int32)


def _check(ext, x, y, gh, gw, row_base, col_base, col_sharded,
           interpolation, edge_x, edge_y, edge_color):
    if ext.dim() != 3 or ext.shape[2] != 4 or ext.dtype != torch.float32:
        raise ValueError(
            f"the block must be (ext_h, ext_w, 4) float32, got "
            f"{tuple(ext.shape)} {ext.dtype}")
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(
            f"x and y must be (H, W) grids of one shape, got "
            f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x and y must be float32, got {x.dtype}, {y.dtype}")
    if not (x.device == y.device == ext.device):
        raise ValueError(
            f"the block, x and y must share a device, got {ext.device}, "
            f"{x.device}, {y.device}")
    if not (ext.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the block, x and y must be contiguous")
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation must be one of {tuple(INTERPOLATIONS)}")
    if edge_x not in EDGES or edge_y not in EDGES:
        raise ValueError(f"edge behaviors must be one of {tuple(EDGES)}")
    if len(edge_color) != 4:
        raise ValueError("edge_color needs 4 components")
    ext_h, ext_w = int(ext.shape[0]), int(ext.shape[1])
    if ext_h < 1 or ext_w < 1 or gh < 1 or gw < 1:
        raise ValueError(f"empty block {ext_h}x{ext_w} or frame {gh}x{gw}")
    if not col_sharded and gw != ext_w:
        raise ValueError(
            f"a block whose columns are not split spans the frame's width: "
            f"{ext_w} != {gw}")
    if ext_h * ext_w >= MAX_SOURCE_PIXELS or 2 * max(gh, gw) >= 2**31:
        raise ValueError(
            f"block of {ext_h}x{ext_w} or frame {gh}x{gw} exceeds the "
            f"kernel's int32 indexing")
    for v in (row_base, col_base):
        if abs(int(v)) >= 2**30:
            raise ValueError(f"block base {v} exceeds the kernel's int32 indexing")


#: the C interface's parameters, csrc/sample_tiled.cu::mm_sample_tiled
ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ext block
    ctypes.c_int, ctypes.c_int,  # gh, gw
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row_base, col_base, col_sharded
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, y, out
    ctypes.c_int, ctypes.c_int,  # h, w
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # interp, edge_x, edge_y
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p,  # excess (NULL = not measured)
    ctypes.c_void_p,  # stream
)


@functools.cache
def _kernel():
    return build.function("mm_sample_tiled", ARGTYPES)


def sample_tiled(ext, x, y, gh: int, gw: int, row_base: int, col_base: int,
                 col_sharded: bool, interpolation: str, edge_x: str,
                 edge_y: str, edge_color, check: bool = True):
    """Sample the block `ext` at world coordinate grids `x`, `y` ((H, W)
    float32) -> (planar (4, H, W) float32, excess), where excess is a 0-d
    int32 tensor on the block's device, or None when `check` is False.

    A CPU block goes to the plain version; a CUDA block launches the kernel
    on the current stream (no synchronisation) or raises."""
    _check(ext, x, y, gh, gw, row_base, col_base, col_sharded, interpolation,
           edge_x, edge_y, edge_color)
    if ext.device.type == "cpu":
        out, excess = sample_tiled_reference(
            ext, x, y, gh, gw, row_base, col_base, col_sharded, interpolation,
            edge_x, edge_y, edge_color)
        return out, (excess if check else None)
    if ext.device.type != "cuda":
        raise ValueError(f"no tiled sampler for device {ext.device}")
    h, w = int(x.shape[0]), int(x.shape[1])
    out = torch.empty((4, h, w), dtype=torch.float32, device=ext.device)
    excess = (torch.full((), NO_EXCESS, dtype=torch.int32, device=ext.device)
              if check else None)
    if out.numel() == 0:
        return out, excess
    if ext.data_ptr() % 16:
        raise ValueError("the block must be 16-byte aligned for float4 loads")
    kernel = _kernel()
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(ext.data_ptr(), int(ext.shape[0]), int(ext.shape[1]),
                     int(gh), int(gw), int(row_base), int(col_base),
                     int(bool(col_sharded)), x.data_ptr(), y.data_ptr(),
                     out.data_ptr(), h, w, INTERPOLATIONS[interpolation],
                     EDGES[edge_x], EDGES[edge_y],
                     *(float(c) for c in edge_color),
                     excess.data_ptr() if check else None, stream)
    build.raise_for(err, "sample_tiled")
    count("launch.sample_tiled")
    return out, excess

