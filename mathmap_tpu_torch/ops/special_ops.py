"""Special functions: gamma, lgamma, beta, the complete elliptic integrals
and the Jacobi elliptic functions (the port of
`mathmap_tpu/ops/special_ops.py`).

Each is written in elementwise torch ops over the whole grid:

  - gamma: the Lanczos approximation (g=7, n=9) with reflection for
    x < 0.5; also in split re/im form for `ri:` arguments (no reflection
    there, as in the reference).
  - lgamma: the same series summed in logs, so it does not overflow.
  - ellK/ellE: the AGM with a fixed trip count.
  - Jacobi sn/cn/dn: the descending Landen chain with a fixed trip count.

The trigonometric calls go through ops/libm.py, so the CPU route computes
them with numpy's float32 ufuncs, the oracle's own.

**The oracle's float64 tail.** The reference writes sqrt(2 pi), log(2 pi)
and log(pi) as `be.sqrt(2.0 * _PI)` and the like: under NumPy 2 those are
float64 scalars, which promote the float32 arrays they meet, so the NumPy
oracle returns gamma, lgamma and beta (and everything computed from them)
in float64, while the jit path's weak types keep float32. This port keeps
float32 throughout its float32 renders: the constants are Python floats,
rounded to float32 where they meet it, as the jit path rounds them. That
reproduces the goldens of every library entry that calls these functions
(gamma_spiral) and the oracle within the parity tolerance (rtol=1e-4,
atol=1e-5; tests/test_torch_vector_special.py). The float64 spec render
(`render(interpret=True, precision="f64")`) takes the oracle's float64
constants instead (`_constants`).
"""

from __future__ import annotations

import math

import torch

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from ..utils.trace import span
from . import libm
from .registry import builtin, need_args

#: Lanczos g=7, n=9 coefficients (Godfrey / Numerical Recipes standard set)
_LANCZOS_G = 7.0
_LANCZOS_C = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)

_PI = math.pi
_SQRT_2PI = math.sqrt(2.0 * _PI)
_LOG_2PI = math.log(2.0 * _PI)
_LOG_PI = math.log(_PI)
_LITERAL = span("mm.sync.literal")


def _rdiv(c: float, t):
    """c / t with c rounded to t's dtype first, as NumPy divides by a
    Python float; torch's `c / t` multiplies by t's reciprocal instead."""
    return _LITERAL.tensor(c, t.dtype, t.device) / t


def _constants(ev):
    """(sqrt(2 pi), log(2 pi), log(pi)): Python floats in a float32 render;
    in the float64 spec render the oracle's float64 scalars, 0-d float64
    tensors that promote a float32 argument as NumPy's do."""
    if ev.ctx.dtype == torch.float64:
        return tuple(ev.lit(v) for v in (_SQRT_2PI, _LOG_2PI, _LOG_PI))
    return _SQRT_2PI, _LOG_2PI, _LOG_PI


def _lanczos(x):
    """The reflection mask, z = (x or 1 - x) - 1, the series and t."""
    reflect = x < 0.5
    z = torch.where(reflect, 1.0 - x, x) - 1.0
    acc = _LANCZOS_C[0]
    for i, c in enumerate(_LANCZOS_C[1:], start=1):
        acc = acc + _rdiv(c, z + i)
    t = z + _LANCZOS_G + 0.5
    return reflect, z, acc, t


def _gamma_real(x, consts):
    """Lanczos gamma for real x; gamma(x) = pi / (sin(pi x) gamma(1 - x))
    for x < 0.5. `consts`: `_constants(ev)`."""
    reflect, z, acc, t = _lanczos(x)
    g = consts[0] * libm.pow(t, z + 0.5) * torch.exp(-t) * acc
    return torch.where(reflect, _rdiv(_PI, libm.sin(_PI * x) * g), g)


def _lgamma_real(x, consts):
    """log|gamma(x)| in log form: the same series and reflection, summed in
    logs (log(abs(gamma(x))) overflows float32 past x ~ 35)."""
    _, log_2pi, log_pi = consts
    reflect, z, acc, t = _lanczos(x)
    lg = 0.5 * log_2pi + (z + 0.5) * torch.log(t) - t + torch.log(torch.abs(acc))
    return torch.where(reflect, log_pi - torch.log(torch.abs(libm.sin(_PI * x))) - lg, lg)


def _gamma_complex(re, im, consts):
    """Lanczos gamma in split re/im form (valid for Re(z) >= 0.5)."""
    zr, zi = re - 1.0, im
    ar = torch.zeros_like(zr) + _LANCZOS_C[0]
    ai = torch.zeros_like(zr)
    for i, c in enumerate(_LANCZOS_C[1:], start=1):
        dr, di = zr + i, zi
        d2 = dr * dr + di * di
        ar = ar + c * dr / d2
        ai = ai - c * di / d2
    tr, ti = zr + _LANCZOS_G + 0.5, zi
    # t^(z+0.5) = exp((z+0.5) * log t)
    log_tr = 0.5 * torch.log(tr * tr + ti * ti)
    log_ti = libm.atan2(ti, tr)
    pr, pi_ = zr + 0.5, zi
    er = pr * log_tr - pi_ * log_ti
    ei = pr * log_ti + pi_ * log_tr
    m = torch.exp(er - tr)
    cosv, sinv = libm.cos(ei - ti), libm.sin(ei - ti)
    gr = consts[0] * m * (cosv * ar - sinv * ai)
    gi = consts[0] * m * (cosv * ai + sinv * ar)
    return gr, gi


@builtin("gamma")
def _gamma(ev, args, span):
    (a,) = need_args(args, 1, "gamma", span)
    if a.tag == "ri":
        return TupleValue("ri", _gamma_complex(a.arrays[0], a.arrays[1], _constants(ev)))
    if a.is_opaque or a.length != 1:
        raise MMTypeError("'gamma' expects a single value or ri: tuple", span)
    return TupleValue(NIL, (_gamma_real(a.arrays[0], _constants(ev)),))


@builtin("lgamma")
def _lgamma(ev, args, span):
    (a,) = need_args(args, 1, "lgamma", span)
    return TupleValue(NIL, (_lgamma_real(a.scalar(span), _constants(ev)),))


@builtin("beta")
def _beta(ev, args, span):
    a, b = need_args(args, 2, "beta", span)
    x, y = a.scalar(span), b.scalar(span)
    c = _constants(ev)
    return TupleValue(NIL, (_gamma_real(x, c) * _gamma_real(y, c) / _gamma_real(x + y, c),))


# ---------------------------------------------------------------------------
# elliptic integrals and functions (modulus k; parameter m = k^2)
# ---------------------------------------------------------------------------

#: AGM steps: float32 converges in ~6; a fixed count keeps it branch-free
_AGM_ITERS = 12


def _agm_ke(k):
    """The complete elliptic integrals K(k), E(k) by the AGM."""
    a = torch.ones_like(k)
    b = libm.sqrt(1.0 - k * k)
    c_sum = 0.5 * k * k
    pow2 = 1.0
    for _ in range(_AGM_ITERS):
        an = 0.5 * (a + b)
        bn = libm.sqrt(a * b)
        cn = 0.5 * (a - b)
        pow2 = pow2 * 2.0
        c_sum = c_sum + 0.5 * pow2 * cn * cn
        a, b = an, bn
    big_k = _rdiv(_PI, 2.0 * a)
    return big_k, big_k * (1.0 - c_sum)


@builtin("ell_int_Kcomp", "ellK")
def _ell_k(ev, args, span):
    (a,) = need_args(args, 1, "ell_int_Kcomp", span)
    return TupleValue(NIL, (_agm_ke(a.scalar(span))[0],))


@builtin("ell_int_Ecomp", "ellE")
def _ell_e(ev, args, span):
    (a,) = need_args(args, 1, "ell_int_Ecomp", span)
    return TupleValue(NIL, (_agm_ke(a.scalar(span))[1],))


def _jacobi_sn_cn_dn(u, k):
    """Jacobi sn, cn, dn by the AGM and the descending Landen chain, at a
    fixed depth (Abramowitz & Stegun 16.4)."""
    a = torch.ones_like(k)
    b = libm.sqrt(1.0 - k * k)
    levels = []  # (a_i, c_i), i = 1..n, after each update
    for _ in range(_AGM_ITERS):
        an = 0.5 * (a + b)
        c = 0.5 * (a - b)
        b = libm.sqrt(a * b)
        a = an
        levels.append((a, c))
    # phi_n = 2^n a_n u, then 2 phi_{i-1} = phi_i + asin(c_i / a_i sin phi_i)
    phi = (2.0 ** _AGM_ITERS) * a * u
    for a_i, c_i in reversed(levels):
        phi = 0.5 * (phi + libm.asin(torch.clamp(c_i / a_i * libm.sin(phi), -1.0, 1.0)))
    sn, cn = libm.sin(phi), libm.cos(phi)
    dn = libm.sqrt(torch.clamp(1.0 - (k * sn) * (k * sn), min=0.0))
    return sn, cn, dn


def _jac(name: str, idx: int):
    @builtin(f"ell_jac_{name}", f"jac_{name}")
    def _op(ev, args, span, _idx=idx, _name=name):
        u, k = need_args(args, 2, f"ell_jac_{_name}", span)
        return TupleValue(NIL, (_jacobi_sn_cn_dn(u.scalar(span), k.scalar(span))[_idx],))


_jac("sn", 0)
_jac("cn", 1)
_jac("dn", 2)
