"""The reference's random-program fuzz through the port, each generator
imported from tests/test_fuzz.py, not copied, and rendered by the port on
the CPU against the NumPy oracle (`interpret=True`) at its test's
tolerance, rtol=1e-3, atol=1e-4:

- the 60 ExprGen seeds of test_random_expression_parity (scalar
  expressions over the internals, loops static and per pixel, nested
  loops, internal-variable shadowing, rand() inside a loop whose condition
  assigns and after it);
- the 40 AlgebraGen seeds of test_random_algebra_parity (complex
  arithmetic, tuple sub-assignment, color and polar round trips, matrix,
  vector and quaternion products);
- the 30 ExoticGen seeds of test_random_exotic_semantics_parity (do-while
  carries, branch-only widening of internals, dynamic-index assignment,
  assignment as an expression, user tags)."""

import numpy as np
import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from test_fuzz import H, W, AlgebraGen, ExoticGen, ExprGen


def _check(src, seed):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    oracle = mm.compile(src).render(img, interpret=True)
    got = mt.compile_source(src).render(img, device="cpu").numpy()
    assert np.isfinite(got).all(), src
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-4, err_msg=src)


@pytest.mark.parametrize("seed", range(60))
def test_random_expression_parity(seed):
    _check(ExprGen(seed).program(), seed)


@pytest.mark.parametrize("seed", range(400, 440))
def test_random_algebra_parity(seed):
    _check(AlgebraGen(seed).program(), seed)


@pytest.mark.parametrize("seed", range(600, 630))
def test_random_exotic_semantics_parity(seed):
    _check(ExoticGen(seed).program(), seed)
