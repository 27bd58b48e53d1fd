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
`TiledInput`, through kernel B4. Animated inputs are not ported yet
(ROADMAP A4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.sample_tiled import localize_period  # noqa: F401  (the reference's home of it)
from ..utils.errors import MMTypeError
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


@dataclass
class InputImage(ImageBase):
    """An input drawable: `pixels` is an (H, W, 4) RGBA tensor on the
    render device, float32 in [0, 1] or uint8. A uint8 image stays uint8:
    the sampler reads u8 taps and converts each one, so the upload is 4x
    smaller and the values equal a float32 upload's."""

    pixels: torch.Tensor
    name: str = "in"

    def sample(self, ev, x, y, frame=None):
        return sampling.sample_image(ev, self, x, y, frame=frame)


@dataclass
class TiledInput(InputImage):
    """One tile's input block of the input-sharded renderer
    (parallel/halo.py): `pixels` is the tile's rows (and columns, when the
    mesh splits columns) PLUS the halo rows/cols taken from its ring
    neighbours, (ext_h, ext_w, 4) float32 on the tile's device. Global
    index (row_base, col_base) is local (0, 0). A sample beyond the halo
    clamps into the block (the bounded-displacement contract);
    `violation_hook`, when set, receives how far past the block any tap
    reached (<= 0 when the contract held), as a 0-d int32 tensor."""

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
        return self.global_height, self.global_width or int(self.pixels.shape[1])

    def sample(self, ev, x, y, frame=None):
        return sampling.sample_tiled(ev, self, x, y)


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


def _ramp(resolution: int, device) -> torch.Tensor:
    """np.linspace(0, 1, resolution, dtype=float32) on `device`, bit for
    bit: computed in float64 and rounded once, as numpy does (a float32
    torch.linspace differs from it in the last place)."""
    return torch.from_numpy(
        np.linspace(0.0, 1.0, resolution, dtype=np.float32)).to(device)


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
        out = fn(_ramp(resolution, device))
        return Curve(lut=torch.as_tensor(out, dtype=torch.float32, device=device))


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
