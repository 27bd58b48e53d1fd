"""The builtin of the whole-image filters (the port of
`mathmap_tpu/ops/native_ops.py`)."""

from __future__ import annotations

from ..runtime.native_filters import native_gaussian_blur
from .registry import builtin, need_args


@builtin("gaussian_blur", "gaussian-blur", "gaussianBlur")
def _gaussian_blur(ev, args, span):
    img, stddev = need_args(args, 2, "gaussian_blur", span)
    return native_gaussian_blur(ev, img, stddev, span)
