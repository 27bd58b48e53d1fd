"""The reference's random-expression fuzz through the port: the 60 ExprGen
seeds of tests/test_fuzz.py::test_random_expression_parity (scalar
expressions over the internals, loops static and per pixel, nested loops,
internal-variable shadowing, rand() inside a loop whose condition assigns
and after it), rendered by the port on the CPU against the NumPy oracle
(`interpret=True`) at that test's tolerance, rtol=1e-3, atol=1e-4. The
generator is imported from tests/test_fuzz.py, not copied."""

import numpy as np
import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from test_fuzz import H, W, ExprGen


@pytest.mark.parametrize("seed", range(60))
def test_random_expression_parity(seed):
    src = ExprGen(seed).program()
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    oracle = mm.compile(src).render(img, interpret=True)
    got = mt.compile_source(src).render(img, device="cpu").numpy()
    assert np.isfinite(got).all(), src
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-4, err_msg=src)
