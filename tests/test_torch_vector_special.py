"""The vector, matrix, quaternion and special builtins through the port on
the CPU: tests/test_ops.py's matrix, quaternion, elliptic, Jacobi, beta,
lgamma and opaque-operand cases, each rendered by the port and held to the
closed form of that test and to the NumPy oracle (`interpret=True`,
rtol=1e-4, atol=1e-5); and the special functions over whole grids of
arguments (reflection, poles' neighbourhoods, the complex overload), where
the oracle finishes gamma, lgamma and beta in float64 and the port in
float32 (ops/special_ops.py)."""

import math

import numpy as np
import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt

W, H = 8, 6
RTOL, ATOL = 1e-4, 1e-5


def run_gray(expr: str) -> np.ndarray:
    """`grayColor(expr)` rendered by the port, held to the oracle; its red
    channel."""
    src = f"grayColor({expr})"
    img = np.zeros((H, W, 4), np.float32)
    got = mt.compile_source(src).render(img, device="cpu").numpy()
    want = mm.compile(src).render(img, interpret=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=src)
    return got[..., 0]


def ones():
    return np.ones((H, W))


# ---------------------------------------------------------------------------
# tests/test_ops.py: matrices, quaternions, elliptic, Jacobi, beta, lgamma
# ---------------------------------------------------------------------------

def test_matrix_ops():
    np.testing.assert_allclose(run_gray("(m2x2:[1,2,3,4] * v2:[5,6])[0] / 17"), ones(), rtol=1e-6)
    np.testing.assert_allclose(run_gray("det(m2x2:[1,2,3,4]) / -2"), ones(), rtol=1e-6)
    # solve([[1,2],[3,4]] x = [5,6]) -> x = [-4, 4.5]
    np.testing.assert_allclose(run_gray("solve(m2x2:[1,2,3,4], v2:[5,6])[1] / 4.5"), ones(),
                               rtol=1e-5)
    m = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 2]], np.float64)
    sol = np.linalg.solve(m, np.array([1, 2, 3], np.float64))
    np.testing.assert_allclose(
        run_gray(f"solve(m3x3:[2,1,0,1,3,1,0,1,2], v3:[1,2,3])[2] / {sol[2]}"), ones(),
        rtol=1e-5)


def test_quaternion_mul():
    # i * j = k, j * i = -k (Hamilton)
    np.testing.assert_allclose(run_gray("(quat:[0,1,0,0] * quat:[0,0,1,0])[3]"), ones(), rtol=1e-6)
    np.testing.assert_allclose(run_gray("-(quat:[0,0,1,0] * quat:[0,1,0,0])[3]"), ones(),
                               rtol=1e-6)


def test_elliptic_agm():
    from scipy import special

    k = 0.5
    np.testing.assert_allclose(run_gray(f"ell_int_Kcomp({k}) / {special.ellipk(k * k)}"),
                               ones(), rtol=1e-4)
    np.testing.assert_allclose(run_gray(f"ell_int_Ecomp({k}) / {special.ellipe(k * k)}"),
                               ones(), rtol=1e-4)


def test_jacobi_sn():
    from scipy import special

    u, k = 0.7, 0.6
    sn, cn, dn, _ = special.ellipj(u, k * k)
    for name, want in (("sn", sn), ("cn", cn), ("dn", dn)):
        np.testing.assert_allclose(run_gray(f"ell_jac_{name}({u}, {k}) / {want}"), ones(),
                                   rtol=1e-4)


def test_beta():
    from scipy import special

    np.testing.assert_allclose(run_gray(f"beta(2.5, 1.5) / {special.beta(2.5, 1.5)}"), ones(),
                               rtol=1e-4)


def test_lgamma_no_overflow():
    """lgamma sums the series in logs: log(gamma(40)) overflows float32."""
    got = float(run_gray("lgamma(40) / 256")[0, 0]) * 256
    assert abs(got - math.lgamma(40)) < 1e-3, got


@pytest.mark.parametrize("src", [
    "filter f (image in) grayColor(det(m2x2:in)) end",
    "filter f (image in) grayColor(gray(m2x2:[1,0,0,1] * in)) end",
])
def test_opaque_retag_and_matrix_opaque_raise(src):
    """Retagging an image, or multiplying a matrix by one, raises
    MMTypeError in both packages."""
    img = np.zeros((2, 2, 4), np.float32)
    with pytest.raises(mm.MMTypeError):
        mm.compile(src).render(img, interpret=True)
    with pytest.raises(mt.MMTypeError):
        mt.compile_source(src).render(img, device="cpu")


# ---------------------------------------------------------------------------
# every product and vector builtin over the grid, against the oracle
# ---------------------------------------------------------------------------

GRID_EXPRS = {
    "m2x2_mat_mat": "(m2x2:[x/4, 1, y/3, 0.5] * m2x2:[0.5, y/5, 1, x/6])[1] / 4",
    "m2x2_mat_vec": "abs(m2x2:[cos(x), sin(y), -sin(y), cos(x)] * xy) / 8",
    "m3x3_mat_mat": "(m3x3:[1, x/4, 0, y/4, 1, 0.2, 0, 0.3, 1] * m3x3:[x/5, 1, 0, 0, 1, y/5, 1, 0, 1])[4]",
    "m3x3_mat_vec": "(m3x3:[1, x/4, 0, y/4, 1, 0.2, 0, 0.3, 1] * [x, y, 1])[2] / 8",
    "scalar_mat": "(0.5 * m2x2:[x, y, 1, 2])[0] + (m3x3:[x, 0, 0, 0, y, 0, 0, 0, 1] * 0.25)[4]",
    "det3": "det(m3x3:[x/4, 1, 0.5, y/4, 2, 0.1, 0.3, 0.2, 1]) / 4",
    "solve2": "solve(m2x2:[2, x/8, y/8, 3], [x, y])[0] / 4",
    "solve3": "solve(m3x3:[4, x/8, 0, y/8, 3, 0.5, 0, 0.5, 2], v3:[x, y, 1])[1] / 4",
    "solve_singular": "clamp(solve(m2x2:[1, 2, 2, 4], [x, y])[0], -1, 2)",
    "quat": "abs(quat:[x/4, y/4, 0.5, 0.1] * quat:[0.2, x/5, y/5, 1]) / 4",
    "cquat": "(cquat:[x/4, y/4, 0.5, 0.1] * cquat:[0.2, x/5, y/5, 1])[2]",
    "hyper": "(hyper:[x/4, y/4, 0.5, 0.1] * hyper:[x/4, y/4, 0.5, 0.1])[3] + 0.5",
    "dotp": "dotp([x, y, 1], [y, x, 0.5]) / 16",
    "crossp": "crossp([x, y, 1], v3:[y, 0.5, x])[1] / 8",
    "normalize": "normalize(xy * floor(x / 3))[0] * 0.5 + 0.5",
    "length": "length(rgba:[x, y, 1, 0.5]) / 8",
}


@pytest.mark.parametrize("name", sorted(GRID_EXPRS))
def test_products_and_vectors_match_the_oracle(name):
    run_gray(GRID_EXPRS[name])


def test_a_singular_solve_gives_inf_or_nan_like_the_oracle():
    # NaN != NaN; +-inf passes neither bound
    src = ("v = solve(m2x2:[1, 2, 2, 4], [x, y]);"
           "rgbaColor(v[0] == v[0], v[0] > 1e30, v[1] < -1e30, 1)")
    img = np.zeros((H, W, 4), np.float32)
    got = mt.compile_source(src).render(img, device="cpu").numpy()
    np.testing.assert_array_equal(got, mm.compile(src).render(img, interpret=True))


# ---------------------------------------------------------------------------
# special functions over grids of arguments
# ---------------------------------------------------------------------------

SPECIAL_EXPRS = {
    "gamma_positive": "gamma(abs(x) + 0.3) / 30",
    "gamma_reflected": "gamma(-abs(x) / 2.3 - 0.05) / 10 + 0.5",
    "gamma_complex": "abs(gamma(ri:[abs(x) / 3 + 0.6, y / 2])) / 4",
    "gamma_complex_phase": "arg(gamma(ri:[abs(x) / 3 + 0.6, y / 2])) / 7 + 0.5",
    "lgamma": "lgamma(abs(x) * 3 + 0.2) / 20",
    "lgamma_reflected": "lgamma(-abs(x) / 2.3 - 0.05) / 4 + 0.5",
    "beta": "beta(abs(x) + 0.5, abs(y) + 0.5)",
    "ellK": "ellK(x / 5) / 3",
    "ellE": "ellE(y / 4) / 2",
    "jac": "(jac_sn(r / 3, 0.8) + jac_cn(x, 0.3) + jac_dn(y, 0.9)) / 3",
}


@pytest.mark.parametrize("name", sorted(SPECIAL_EXPRS))
def test_special_functions_match_the_oracle(name):
    run_gray(SPECIAL_EXPRS[name])
