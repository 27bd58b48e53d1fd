"""Carry the JAX package's render state across to this package.

Both packages parse the same `.mm` source themselves, so the program needs
no conversion; options, input images and params do. Nothing here imports
the JAX package: a reference object is read by attribute name.
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from .runtime.options import RenderOptions

_FIELDS = frozenset(f.name for f in dataclasses.fields(RenderOptions))


def options_from_reference(opts) -> RenderOptions:
    """A reference `RenderOptions` (any dataclass with its fields) -> this
    package's RenderOptions. A field this package does not know raises
    ValueError; `region` and the 'corners' scheme raise NotImplementedError
    (RenderOptions.__post_init__)."""
    names = [f.name for f in dataclasses.fields(opts)]
    unknown = sorted(set(names) - _FIELDS)
    if unknown:
        raise ValueError(f"RenderOptions fields unknown to the port: {unknown}")
    return RenderOptions(**{n: getattr(opts, n) for n in names})


def _rgba(arr: np.ndarray) -> np.ndarray:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> (H, W, 4) in the same
    dtype family: gray repeats to RGB and a missing alpha is opaque (255
    for uint8, 1.0 for float), as imgio.images.to_float_rgba expands."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected an (H, W[, C]) image, got shape {arr.shape}")
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    if arr.shape[2] == 3:
        opaque = 255 if arr.dtype == np.uint8 else 1.0
        alpha = np.full(arr.shape[:2] + (1,), opaque, arr.dtype)
        arr = np.concatenate([arr, alpha], axis=2)
    if arr.shape[2] != 4:
        raise ValueError(f"expected 1/3/4 channels, got {arr.shape[2]}")
    return arr


def inputs_from_numpy(arrays, device) -> list:
    """numpy images -> (H, W, 4) tensors on `device`. uint8 stays uint8 (the
    sampler converts each tap by /255, the reference's in-render rule);
    every other dtype becomes float32."""
    out = []
    for a in arrays:
        arr = np.asarray(a)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        out.append(torch.from_numpy(np.ascontiguousarray(_rgba(arr))).to(device))
    return out


def params_from_reference(params: dict) -> dict:
    """Validate a params dict for this package: floats, ints, bools, and
    color tuples of 3 or 4 numbers pass through as Python values; a
    reference Curve or Gradient (read by its `.lut` attribute) and (N,),
    (N, 3) or (N, 4) numpy arrays become float32 numpy LUTs, which the
    render converts like the reference's convert_userval. Anything else
    (other arrays, callables, strings) raises TypeError."""
    out = {}
    for name, value in params.items():
        if isinstance(value, (bool, np.bool_)):
            out[name] = bool(value)
        elif isinstance(value, numbers.Real):
            out[name] = float(value)
        elif (isinstance(value, (tuple, list)) and len(value) in (3, 4)
              and all(isinstance(c, numbers.Real) for c in value)):
            out[name] = tuple(float(c) for c in value)
        elif _is_lut(getattr(value, "lut", None)) or _is_lut(value):
            lut = getattr(value, "lut", value)
            out[name] = np.array(lut, dtype=np.float32)
        else:
            raise TypeError(
                f"param {name!r}: {type(value).__name__} values are not "
                f"ported (floats, ints, bools, color tuples, curves, "
                f"gradients and LUT arrays are)")
    return out


def _is_lut(value) -> bool:
    """An (N,) curve or (N, 3|4) gradient table held as an array."""
    if not hasattr(value, "__array__") or isinstance(value, (tuple, list)):
        return False
    shape = np.shape(value)
    return (len(shape) == 1 and shape[0] >= 2) or (len(shape) == 2 and shape[1] in (3, 4))
