"""The evaluator's trigonometric functions, one rule per device.

On a float32 CPU tensor each function is numpy's float32 ufunc, the
function the reference's NumPy oracle computes with; torch's CPU kernels
differ from those by an ulp at some inputs, which a filter can amplify into
a whole 8-bit level (rose_curve's cos(petals * a) at a distance scale of 8).
On a CUDA tensor, and on a traced value of the loop generator
(kernels/while_loop.Sym), each is the torch function.
"""

from __future__ import annotations

import numpy as np
import torch

_NUMPY = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "asinh": np.arcsinh, "acosh": np.arccosh, "atanh": np.arctanh,
}


def _cpu_float32(args) -> bool:
    return all(type(a) is torch.Tensor and a.device.type == "cpu"
               and a.dtype == torch.float32 for a in args)


def _function(name: str):
    torch_fn = getattr(torch, name)
    numpy_fn = _NUMPY[name]

    def fn(*args):
        if _cpu_float32(args):
            out = numpy_fn(*(a.numpy() for a in args))
            return torch.from_numpy(np.asarray(out, dtype=np.float32))
        return torch_fn(*args)

    return fn


sin, cos, tan = _function("sin"), _function("cos"), _function("tan")
asin, acos, atan = _function("asin"), _function("acos"), _function("atan")
atan2 = _function("atan2")
sinh, cosh, tanh = _function("sinh"), _function("cosh"), _function("tanh")
asinh, acosh, atanh = _function("asinh"), _function("acosh"), _function("atanh")

#: name -> function, for the loop generator's CPU interpreter
FUNCTIONS = {name: globals()[name] for name in _NUMPY}
