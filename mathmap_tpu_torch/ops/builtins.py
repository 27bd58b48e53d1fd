"""Builtin op table: importing this module (ops/registry.py does, at its
end) populates the port's own registry (ops.registry.BUILTINS).
complex_ops registers the complex-aware exp/sqrt/sin/cos/tan; `__pow`/`pow`
with its complex overload is below.
"""

import torch

from ..runtime.value import TupleValue as _TV
from . import libm
from . import color_ops  # noqa: F401  (colors, HSVA, toXY/toRA)
from . import complex_ops  # noqa: F401  (ri: algebra + overload dispatch)
from . import image_ops  # noqa: F401  (origVal family)
from . import math_ops  # noqa: F401  (arithmetic, trig, logic, rand)
from . import native_ops  # noqa: F401  (gaussian_blur)
from . import noise  # noqa: F401  (Perlin noise)
from . import special_ops  # noqa: F401  (gamma, elliptic, Jacobi)
from . import vector_ops  # noqa: F401  (vectors, matrices, quaternions)
from .registry import broadcast_pair, builtin, need_args, result_tag


@builtin("__pow", "pow")
def _pow_dispatch(ev, args, span):
    """`^` and `pow`: z^w = exp(w * log z) when either side is ri:."""
    a, b = need_args(args, 2, "^", span)
    if a.tag == "ri" or b.tag == "ri":
        def as_ri(v):
            if v.tag == "ri":
                return v
            s = v.scalar(span)
            return _TV("ri", (s, torch.zeros_like(s)))

        return complex_ops.c_pow(as_ri(a), as_ri(b))
    pairs = broadcast_pair(a, b, span, "^")
    return _TV(result_tag(a, b), tuple(libm.pow(x, y) for x, y in pairs))
