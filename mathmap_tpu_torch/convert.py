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
    package's RenderOptions, `region` and the 'corners' scheme included. A
    field this package does not know raises ValueError."""
    names = [f.name for f in dataclasses.fields(opts)]
    unknown = sorted(set(names) - _FIELDS)
    if unknown:
        raise ValueError(f"RenderOptions fields unknown to the port: {unknown}")
    return RenderOptions(**{n: getattr(opts, n) for n in names})


def _rgba(arr: np.ndarray) -> np.ndarray:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> (H, W, 4) in the same
    dtype family, and a (T, H, W, C) stack frame by frame: gray repeats to
    RGB and a missing alpha is opaque (255 for uint8, 1.0 for float), as
    imgio.images.to_float_rgba expands."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim not in (3, 4):
        raise ValueError(
            f"expected an (H, W[, C]) image or a (T, H, W, C) stack, got shape {arr.shape}")
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 3:
        opaque = 255 if arr.dtype == np.uint8 else 1.0
        alpha = np.full(arr.shape[:-1] + (1,), opaque, arr.dtype)
        arr = np.concatenate([arr, alpha], axis=-1)
    if arr.shape[-1] != 4:
        raise ValueError(f"expected 1/3/4 channels, got {arr.shape[-1]}")
    return arr


def inputs_from_numpy(arrays, device) -> list:
    """numpy images -> (H, W, 4) tensors on `device`; a 4-D array is an
    ANIMATED (T, H, W, C) stack -> (T, H, W, 4). uint8 stays uint8 (the
    sampler converts each tap by /255, the reference's in-render rule, and
    a u8 stack stays u8 on the device); every other dtype becomes
    float32."""
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
    render converts like the reference's convert_userval; an image, an
    (H, W, 4) or animated (T, H, W, 4) numpy array, passes through as a
    uint8 or float32 array. Anything else (other arrays, callables,
    strings) raises TypeError."""
    out = {}
    for name, value in params.items():
        if _is_image(value):
            arr = np.asarray(value)
            out[name] = arr if arr.dtype == np.uint8 else arr.astype(np.float32)
        elif isinstance(value, (bool, np.bool_)):
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
                f"gradients, LUT arrays and image arrays are)")
    return out


def _is_lut(value) -> bool:
    """An (N,) curve or (N, 3|4) gradient table held as an array."""
    if not hasattr(value, "__array__") or isinstance(value, (tuple, list)):
        return False
    shape = np.shape(value)
    return (len(shape) == 1 and shape[0] >= 2) or (len(shape) == 2 and shape[1] in (3, 4))


def _is_image(value) -> bool:
    """An (H, W, 4) image or (T, H, W, 4) stack held as a numpy array."""
    return isinstance(value, np.ndarray) and value.ndim in (3, 4) and value.shape[-1] == 4
