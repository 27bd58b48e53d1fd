"""Mirror of tests/test_edge_cases.py on the port: every test of that
module runs its own body with `mm` standing for the port
(tests/_torch_shim.py), each render on the port's CPU route and held
against the reference's `render(..., interpret=True)` at rtol=1e-4,
atol=1e-5 (NaN where the oracle has NaN) before the test's assertions see
it, and the port's errors raised as the reference's classes of the same
name. None is left out."""

import pytest

import test_edge_cases as reference
from _torch_shim import reference_cases, run_case

CASES = reference_cases(reference, set())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_edge_case_on_the_port(case, monkeypatch):
    _, fn, kwargs = case
    run_case(reference, fn, kwargs, monkeypatch)


def test_every_reference_test_is_mirrored():
    assert len(CASES) == sum(n.startswith("test_") for n in vars(reference)) == 10
