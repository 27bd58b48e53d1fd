"""The port's deployment self-test (mathmap_tpu_torch/selftest.py) on the
CPU: `run_selftest` returns 0, and each of its ten path classes, rendered
by the port on the CPU (the route the sweep holds the card against), is
within rtol=1e-4, atol=1e-5 of the JAX package's NumPy oracle
(`interpret=True`), the while-loop class within the reference's fraction
rule (under 1% of values off by more than 0.02).
"""

import numpy as np
import pytest

import mathmap_tpu as mm
from mathmap_tpu_torch import selftest


def test_run_selftest_on_the_cpu_returns_zero(capsys):
    assert selftest.run_selftest(size=64, device="cpu") == 0
    out = capsys.readouterr().out
    assert "device=cpu size=64" in out and "OK (10/10 passed)" in out


@pytest.mark.parametrize("config", selftest._configs(), ids=lambda c: c[0])
def test_each_class_matches_the_oracle(config):
    name, src, kw, frame = config
    size = 64
    got = selftest.render_config(name, src, kw, frame, size, "cpu")
    img, stack = selftest.selftest_inputs(size)
    f = mm.compile_source(src)
    inp = stack if name == "animated-frame" else img
    args = [inp] if f.image_params else []
    want = np.asarray(f.render(*args, width=size, height=size, t=0.25, frame=frame,
                               options=mm.RenderOptions(**kw), interpret=True))
    ok, detail = selftest.compare(name, got, want)
    assert ok, detail
    if name != "while-loop":
        np.testing.assert_allclose(got, want, rtol=selftest.RTOL, atol=selftest.ATOL)


def test_a_failing_class_is_counted(monkeypatch, capsys):
    """A crash or a mismatch is a failure, not an exception."""
    monkeypatch.setattr(selftest, "_configs", lambda: [
        ("broken", "grayColor(nosuchfn(x))", {}, 0.0),
        ("pointwise", "grayColor(x / W + 0.5)", {}, 0.0)])
    assert selftest.run_selftest(size=16, device="cpu") == 1
    assert "broken                   FAIL" in capsys.readouterr().out
