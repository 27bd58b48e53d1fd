"""The evaluator's transcendental functions, `sqrt` and `pow`, one rule per
device.

On a float32 or float64 CPU tensor each function is numpy's ufunc, the
function the reference's NumPy oracle computes with, in its dtype: float32
for the oracle's default precision, float64 for its float64 spec
(`render(interpret=True, precision="f64")`), numpy's promotion deciding a
mixed call. torch's CPU kernels
differ from those by an ulp at some inputs (its vectorised sqrt is not
correctly rounded, its pow and trig are within an ulp), which a filter can
amplify past the oracle's tolerance: rose_curve's cos(petals * a) at a
distance scale of 8 (fault C1), twirl's `(1 - r / R) ^ 2` on a noise image
(fault C3). The CPU route is the custom op `mathmap::libm`, so an exported
program (generators/artifact.py), whose tensors are fake while it is
traced, records it and computes what the live render computes. On a CUDA
tensor, and on a traced value of the loop generator
(kernels/while_loop.Sym), each is the torch function.

This module imports nothing else of the package.
"""

from __future__ import annotations

import numpy as np
import torch

_NUMPY = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "asinh": np.arcsinh, "acosh": np.arccosh, "atanh": np.arctanh,
    "sqrt": np.sqrt, "pow": np.power,
}

torch.library.define("mathmap::libm", "(str name, Tensor[] args) -> Tensor")


def _libm_cpu(name, args):
    return torch.from_numpy(np.asarray(_NUMPY[name](*(a.numpy() for a in args))))


torch.library.impl("mathmap::libm", "CPU")(_libm_cpu)


def _libm_fake(name, args):
    shape = torch.broadcast_shapes(*(a.shape for a in args))
    return args[0].new_empty(shape)


torch.library.register_fake("mathmap::libm")(_libm_fake)


def _cpu_float(args) -> bool:
    return all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               and a.dtype in (torch.float32, torch.float64) for a in args)


def _function(name: str):
    torch_fn = getattr(torch, name)

    def fn(*args):
        if _cpu_float(args):
            return torch.ops.mathmap.libm(name, list(args))
        return torch_fn(*args)

    return fn


sin, cos, tan = _function("sin"), _function("cos"), _function("tan")
asin, acos, atan = _function("asin"), _function("acos"), _function("atan")
atan2 = _function("atan2")
sinh, cosh, tanh = _function("sinh"), _function("cosh"), _function("tanh")
asinh, acosh, atanh = _function("asinh"), _function("acosh"), _function("atanh")
sqrt, pow = _function("sqrt"), _function("pow")  # noqa: A001

#: name -> function, for the loop generator's CPU interpreter
FUNCTIONS = {name: globals()[name] for name in _NUMPY}
