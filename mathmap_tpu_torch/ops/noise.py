"""Perlin noise: the `noise` builtin (the port of the NumPy branch of
`mathmap_tpu/ops/noise.py`).

Every `noise` call evaluates Ken Perlin's improved noise (2002) through
the op `mathmap::perlin3` (kernels/perlin3.py): on the CPU its plain
version, the eager torch chain; on the card kernel B6, one launch a
call. Each call is one `mm.noise` span (the host time of enqueueing one
Perlin evaluation) and adds the points it evaluates to the counter
`noise.points`, and on the card to `noise.kernel_points` too.
"""

from __future__ import annotations

# the table and lattice index are named here for the tests that hold them
# to the JAX package's (tests/test_torch_noise.py)
from ..kernels.perlin3 import _table, lattice, perm_table  # noqa: F401
from ..kernels.perlin3 import perlin3
from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from ..utils.trace import count, span
from .registry import builtin

#: built once, as the hot path's spans are; the builtin's own `span`
#: argument (a source position) shadows the name inside it
_NOISE = span("mm.noise")


@builtin("noise")
def _noise(ev, args, span):
    if len(args) == 1:
        (v,) = args
        if v.is_opaque or v.length != 3:
            raise MMTypeError("'noise' expects a v3:/length-3 tuple or 3 scalars", span)
        x, y, z = v.arrays
    elif len(args) == 3:
        x, y, z = (a.scalar(span) for a in args)
    else:
        raise MMTypeError("'noise' expects 1 tuple or 3 scalar arguments", span)
    with _NOISE:
        out = perlin3(x, y, z)
    count("noise.points", out.numel())
    if out.is_cuda:
        count("noise.kernel_points", out.numel())
    return TupleValue(NIL, (out,))
