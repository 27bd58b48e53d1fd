"""Runtime value model for the evaluator (the port of
`mathmap_tpu/runtime/value.py`).

A MathMap value is a tagged tuple. Each component is a torch tensor: a 0-d
scalar, or a whole-grid (H, W) tensor on the render context's device, so
every scalar op of the per-pixel program is one elementwise torch op over
the grid. Images are first-class values carried in length-1 tuples with the
tag 'image' and the image object in `payload`.

Curves and gradients are LUT-backed opaque values ('curve', 'gradient')
applied through kernel B2 (ops/color_ops.py). A tile of the input-sharded
renderer (parallel/halo.py) samples its halo-extended block, a
`TiledInput`, through kernel B4. An animated input holds a (T, H, W, 4)
stack whose frames are selected by index (runtime/sampling.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.sample_image import u8_to_float
from ..kernels.sample_tiled import localize_period
from ..utils.errors import MMTypeError
from ..utils.trace import span
from . import sampling


class TupleValue:
    """A tagged tuple of tensors (or a payload for opaque values).

    `const` carries host-side Python values for components known before
    the render (source literals and what folds from them)."""

    __slots__ = ("tag", "arrays", "payload", "const")

    def __init__(self, tag: str, arrays: tuple = (), payload: Any = None, const=None):
        self.tag = tag
        self.arrays = tuple(arrays)
        self.payload = payload
        self.const = const

    @property
    def length(self) -> int:
        return len(self.arrays) if self.payload is None else 1

    @property
    def is_opaque(self) -> bool:
        return self.payload is not None

    def retag(self, tag: str) -> "TupleValue":
        return TupleValue(tag, self.arrays, self.payload, self.const)

    def static_scalar(self) -> float | None:
        """The host-side value of a length-1 tuple, if it has one: a
        literal, a param default, a param named in static_params, or what
        folds from them. A passed param's tensor has none, as a traced
        value has none on the reference's jit path."""
        if self.const is not None and len(self.const) == 1:
            return self.const[0]
        return None

    def scalar(self, span=None):
        """The single component of a length-1 tuple."""
        if self.payload is not None or len(self.arrays) != 1:
            raise MMTypeError(
                f"expected a single value, got {self.tag}:{self.length}-tuple", span
            )
        return self.arrays[0]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.payload is not None:
            return f"<{self.tag}:{self.payload!r}>"
        return f"<{self.tag}:{self.length}>"


@dataclass
class ImageBase:
    """Base for first-class image values; sample(ev, x, y[, frame]) -> rgba
    components."""

    def sample(self, ev, x, y, frame=None):  # pragma: no cover - interface
        raise NotImplementedError


#: float32 frame indices at or above this are outside int32: NumPy's cast
#: (x86 cvttss2si) gives INT_MIN there, which the oracle's clip makes frame 0
_INT32_LIMIT = float(2**31)


@dataclass
class InputImage(ImageBase):
    """An input drawable: `pixels` is an (H, W, 4) RGBA tensor on the
    render device, float32 in [0, 1] or uint8, or an ANIMATED (T, H, W, 4)
    stack of such frames, sampled by frame index. A uint8 image stays
    uint8: the sampler reads u8 taps and converts each one, so the upload
    is 4x smaller and the values equal a float32 upload's."""

    pixels: torch.Tensor
    name: str = "in"

    @property
    def num_frames(self) -> int:
        return int(self.pixels.shape[0]) if self.pixels.dim() == 4 else 1

    def frame_index(self, frame):
        """The oracle's frame index: floor(frame + 0.5) in float32, cast to
        int32, clipped to [0, T-1]. A NaN, an infinity or an index outside
        int32 casts to INT_MIN in NumPy on x86 and so clips to frame 0; the
        index is mapped in float before any cast, since CUDA's conversion
        saturates instead (+inf would select T-1). `frame`: a Python float
        or a 0-d tensor -> an int; a grid tensor -> an int64 grid."""
        last = self.num_frames - 1
        if isinstance(frame, torch.Tensor) and frame.dim() > 0:
            fi = torch.floor(frame.to(torch.float32) + 0.5)
            inside = (fi >= 0) & (fi < _INT32_LIMIT)
            return torch.where(inside, torch.clamp(fi, max=last), 0).to(torch.int64)
        fi = float(np.floor(np.float32(float(frame)) + np.float32(0.5)))
        return min(int(fi), last) if 0 <= fi < _INT32_LIMIT else 0

    def frame_pixels(self, frame):
        """(H, W, 4) pixels of a scalar `frame`: a view of the stack, no
        copy (a single-frame input is its own pixels)."""
        if self.pixels.dim() != 4:
            return self.pixels
        return self.pixels[self.frame_index(frame)]

    @property
    def global_shape(self):
        return int(self.pixels.shape[-3]), int(self.pixels.shape[-2])

    def make_gather(self, frames):
        """The two-axis gather of an animated input (the reference's
        `make_gather` on a 4-D stack): `gather(iy, ix)` maps in-range index
        grids to 4 float32 channel grids, each tap read from its pixel's
        frame in `frames`, an int64 grid. The index within a frame stays
        within int32 however long the animation."""
        h, w = self.global_shape
        flat = self.pixels.reshape(self.num_frames, h * w, 4)

        def gather(iy, ix):
            g = flat[frames, (iy * w + ix).long()]
            if g.dtype == torch.uint8:
                g = u8_to_float(g)
            return [g[..., c] for c in range(4)]

        return gather

    def sample(self, ev, x, y, frame=None):
        return sampling.sample_image(ev, self, x, y, frame=frame)


@dataclass
class TiledInput(InputImage):
    """One tile's input block of the input-sharded renderer
    (parallel/halo.py): `pixels` is the tile's rows (and columns, when the
    mesh splits columns) PLUS the halo rows/cols taken from its ring
    neighbours, (ext_h, ext_w, 4) float32 on the tile's device, or a
    (T, ext_h, ext_w, 4) stack of an animated input's frames, every frame
    sharded alike. Global index (row_base, col_base) is local (0, 0). A
    sample beyond the halo clamps into the block (the bounded-displacement
    contract); `violation_hook`, when set, receives how far past the block
    any tap reached (<= 0 when the contract held), as a 0-d int32
    tensor."""

    global_height: int = 0
    #: 0 = the columns are not split (the block spans the full width)
    global_width: int = 0
    row_base: int = 0
    col_base: int = 0
    #: halo widths exchanged and painted around the block
    halo_y: int = 0
    halo_x: int = 0
    violation_hook: Any = None

    @property
    def global_shape(self):
        return self.global_height, self.global_width or int(self.pixels.shape[-2])

    def make_gather(self, frames):
        """The two-axis gather of an animated block (the reference's
        `TiledInput.make_gather`): globally edge-mapped taps are localised
        to the block (`localize_period`) and clamped into it, each read
        from its pixel's frame in `frames`; a set violation hook receives
        each tap's excess past the block."""
        ext_h, ext_w = int(self.pixels.shape[-3]), int(self.pixels.shape[-2])
        gh, gw = self.global_shape
        flat = self.pixels.reshape(self.num_frames, ext_h * ext_w, 4)
        col_sharded = bool(self.global_width)
        hook = self.violation_hook

        def gather(iy, ix):
            ly = torch.clamp(localize_period(iy, self.row_base, gh, ext_h), 0, ext_h - 1)
            lx = ix
            if col_sharded:
                lx = torch.clamp(localize_period(ix, self.col_base, gw, ext_w), 0, ext_w - 1)
            if hook is not None:
                excess = (torch.remainder(iy - self.row_base, gh) - (ext_h - 1)).max()
                if col_sharded:
                    excess = torch.maximum(
                        excess, (torch.remainder(ix - self.col_base, gw) - (ext_w - 1)).max())
                hook(excess)
            g = flat[frames, (ly * ext_w + lx).long()]
            return [g[..., c] for c in range(4)]

        return gather

    def sample(self, ev, x, y, frame=None):
        return sampling.sample_tiled(ev, self, x, y, frame=frame)


@dataclass
class ClosureImage(ImageBase):
    """A filter (partially) applied to arguments — an image value. Applying
    it to coordinates evaluates the filter body with those coordinates
    bound (filter inlining)."""

    filter_def: Any  # lang.astnodes.FilterDef
    args: tuple = ()  # tuple[TupleValue], one per filter param
    name: str = "closure"

    def sample(self, ev, x, y, frame=None):
        # closures have no frame axis; an explicit frame index is ignored
        return ev.eval_filter_at(self.filter_def, self.args, x, y)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A param's LUT or image on `device`: a copy from the host, which on a
    card waits for the device's queue (a `mm.sync.param` span)."""
    if t.device.type != "cpu":
        return t.to(device)
    with span("mm.sync.param"):
        return t.to(device)


def _ramp(resolution: int, device) -> torch.Tensor:
    """np.linspace(0, 1, resolution, dtype=float32) on `device`, bit for
    bit: computed in float64 and rounded once, as numpy does (a float32
    torch.linspace differs from it in the last place)."""
    return to_device(torch.from_numpy(np.linspace(0.0, 1.0, resolution, dtype=np.float32)),
                     device)


@dataclass
class Curve:
    """A user-editable 1-D function sampled as a (K,) float32 LUT over
    [0, 1]; application clamps the position to [0, 1]."""

    lut: torch.Tensor  # (K,) float32
    name: str = "curve"

    @staticmethod
    def identity(device, resolution: int = 256) -> "Curve":
        return Curve(lut=_ramp(resolution, device))

    @staticmethod
    def from_function(device, fn: Callable[[torch.Tensor], Any],
                      resolution: int = 256) -> "Curve":
        out = torch.as_tensor(fn(_ramp(resolution, device)), dtype=torch.float32)
        return Curve(lut=to_device(out, device))


@dataclass
class Gradient:
    """A color gradient: a (K, 4) float32 RGBA LUT over [0, 1]."""

    lut: torch.Tensor  # (K, 4) float32
    name: str = "gradient"

    @staticmethod
    def default(device, resolution: int = 256) -> "Gradient":
        """Black to white, opaque."""
        ramp = _ramp(resolution, device)
        return Gradient(lut=torch.stack([ramp, ramp, ramp, torch.ones_like(ramp)], dim=-1))


def image_value(img: ImageBase) -> TupleValue:
    return TupleValue("image", payload=img)


def curve_value(c: Curve) -> TupleValue:
    return TupleValue("curve", payload=c)


def gradient_value(g: Gradient) -> TupleValue:
    return TupleValue("gradient", payload=g)
