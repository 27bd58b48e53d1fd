"""NumPy 2's type promotion for the float64 spec render.

The reference's float64 spec (`render_oracle(precision="f64")`) is NumPy
code, and NumPy 2 promotes by dtype alone: a 0-d float64 array meeting a
float32 array of any shape gives float64. PyTorch lets a dimensioned
tensor decide against a 0-d one of its category, so the same expression
stays float32 there: a float64 literal, `t` or folded constant times a
float32 comparison mask, rand() draw, LUT or gaussian_blur result keeps
float32 in torch and is float64 in the spec. Python scalars are weak in
both and need nothing.

`NumpyPromotion` is a torch function mode that restores NumPy's rule for
the duration of a float64 render: before a torch function runs, its
float32 tensor arguments become float64 when a float64 tensor is among
them. What the spec keeps float32 (masks, rand() draws, LUTs, user
values, blurred images) stays float32 until it meets float64, exactly as
in the spec. Functions that do not compute with their tensor arguments
(conversions, views, indexing, broadcasting), in-place ones and the
package's kernels (`mathmap::` ops, whose plain versions follow NumPy's
rule on their own: a float32 LUT or image stays float32 beside float64
positions) are left as they are.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

#: torch functions that take two float tensors but convert, view, store or
#: broadcast rather than compute with them, and the package's custom ops
_KEEP = frozenset({
    "to", "type_as", "expand_as", "view_as", "reshape_as", "broadcast_tensors",
    "__setitem__", "sample_image", "apply_lut", "while_loop", "libm", "finish_rgba",
    "finish_rgba_out",
})


def _in_place(name: str) -> bool:
    return (name.endswith("_") and not name.endswith("__")) or name.startswith("__i")


def _floats(value, found: set):
    if isinstance(value, torch.Tensor):
        if value.dtype in (torch.float32, torch.float64):
            found.add(value.dtype)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _floats(v, found)


def _widen(value):
    if isinstance(value, torch.Tensor):
        return value.to(torch.float64) if value.dtype == torch.float32 else value
    if isinstance(value, (list, tuple)):
        return type(value)(_widen(v) for v in value)
    return value


class NumpyPromotion(TorchFunctionMode):
    """Promote float32 tensor arguments to float64 whenever a float64
    tensor is among a torch function's arguments (NumPy 2's rule)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name not in _KEEP and not _in_place(name):
            found: set = set()
            _floats(args, found)
            _floats([v for k, v in kwargs.items() if k != "out"], found)
            if len(found) == 2:
                args = _widen(args)
                kwargs = {k: v if k == "out" else _widen(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)
