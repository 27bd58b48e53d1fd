"""Runtime value model for the evaluator (the port of
`mathmap_tpu/runtime/value.py`).

A MathMap value is a tagged tuple. Each component is a torch tensor: a 0-d
scalar, or a whole-grid (H, W) tensor on the render context's device, so
every scalar op of the per-pixel program is one elementwise torch op over
the grid. Images are first-class values carried in length-1 tuples with the
tag 'image' and the image object in `payload`.

Animated inputs, prepared (padded) images, tiled inputs, curves and
gradients are not ported yet (ROADMAP A4, A6, A9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

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


def image_value(img: ImageBase) -> TupleValue:
    return TupleValue("image", payload=img)
