"""Mirror of tests/test_docs.py's tutorial checks on the port: every
`mathmap` snippet of docs/TUTORIAL.md compiles with the port and renders
at 24x16, t=0.3, on its CPU route, finite and equal to the reference's
`render(..., interpret=True)` at rtol=1e-4, atol=1e-5 (tighter than the
reference test's rtol=1e-3, atol=1e-4 between its jit path and oracle).
The snippets and the inputs are the reference test's own."""

import numpy as np
import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from _torch_shim import assert_matches_oracle
from test_docs import SNIPPETS


def test_tutorial_has_snippets():
    assert len(SNIPPETS) >= 10


@pytest.mark.parametrize("idx", range(len(SNIPPETS)))
def test_tutorial_snippets_render(idx):
    src = SNIPPETS[idx]
    f = mt.compile_source(src)
    rng = np.random.RandomState(idx)
    inputs = [rng.rand(16, 24, 4).astype(np.float32) for _ in f.image_params]
    out = f.render(*inputs, width=24, height=16, t=0.3, interpret=True).numpy()
    ref = mm.compile(src).render(*inputs, width=24, height=16, t=0.3, interpret=True)
    assert out.shape == (16, 24, 4)
    assert np.isfinite(out).all(), src
    assert_matches_oracle(out, ref, src)
