"""The reference's public API over the port, for the port's mirrors of the
reference's test modules (tests/test_torch_language.py,
test_torch_edge_cases.py, test_torch_docs.py).

`port_api()` returns a stand-in for the `mathmap_tpu` module that a
reference test module calls as `mm`. `mm.compile(src)` compiles the source
with the port, and the returned filter's `render(...)` renders on the
port's CPU route: `interpret=True` is the port's `interpret=True`, and a
render without it the port's `device="cpu"` route, which runs the same
plain kernels. Every render is then held against the reference's own
`render(..., interpret=True)` of the same source and arguments, at
rtol=1e-4, atol=1e-5 and the same dtype (uint8 output within one level,
the repo's packed-output rule), before the port's output goes back to the
test as a numpy array, where the test's own assertions hold it to its
expected values at the test's tolerance. `render_animation`,
`render_batch` and `render_frames` are the port's on the CPU; the tests
compare them with single renders, which the oracle holds.

`mm.RenderOptions` is the port's, so option validation is the port's;
the oracle render gets the same fields as the reference's options. The
port's MathMap errors are raised as the reference's classes of the same
name (same message and span), so the tests' `pytest.raises` hold.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.utils import errors as ref_errors
from mathmap_tpu_torch.utils import errors as port_errors

RTOL, ATOL = 1e-4, 1e-5


@contextlib.contextmanager
def reference_errors():
    """Raise a port MathMap error as the reference's class of that name."""
    try:
        yield
    except port_errors.MMError as exc:
        cls = getattr(ref_errors, type(exc).__name__)
        span = ref_errors.Span(**dataclasses.asdict(exc.span))
        raise cls(exc.message, span, exc.source) from exc


def reference_options(opts):
    """The port's RenderOptions (or None) -> the reference's, field for
    field."""
    if opts is None:
        return None
    return mm.RenderOptions(**{f.name: getattr(opts, f.name)
                               for f in dataclasses.fields(opts)})


def _port_params(params):
    """Reference Curve/Gradient objects become their LUT arrays; every
    other value passes as it is."""
    if params is None or isinstance(params, (list, tuple)):
        return params
    return {k: np.asarray(v.lut) if hasattr(v, "lut") else v for k, v in params.items()}


def assert_matches_oracle(got, oracle, what=""):
    assert got.shape == oracle.shape, (what, got.shape, oracle.shape)
    assert got.dtype == oracle.dtype, (what, got.dtype, oracle.dtype)
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - oracle.astype(np.int16))
        assert diff.max() <= 1, what
    else:
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL, err_msg=str(what))


class PortFilter:
    """A port Filter behind the reference's render signatures."""

    def __init__(self, port, compile_reference):
        self._port = port
        self._compile_reference = compile_reference

    def __getattr__(self, name):
        return getattr(self._port, name)

    def render(self, *inputs, interpret=False, precision="f32", on_error="raise", **kw):
        opts = kw.get("options")
        port_kw = dict(kw, params=_port_params(kw.get("params")))
        with reference_errors():
            if interpret:
                out = self._port.render(*inputs, interpret=True, precision=precision,
                                        on_error=on_error, **port_kw)
            else:
                out = self._port.render(*inputs, device="cpu", **port_kw)
        out = out.numpy()
        oracle = self._compile_reference().render(
            *inputs, interpret=True, precision=precision if interpret else "f32",
            **dict(kw, options=reference_options(opts)))
        assert_matches_oracle(out, np.asarray(oracle), self._port.source)
        return out

    def render_animation(self, *inputs, **kw):
        with reference_errors():
            return self._port.render_animation(*inputs, device="cpu", **kw).numpy()

    def render_batch(self, *inputs, **kw):
        with reference_errors():
            return self._port.render_batch(*inputs, device="cpu", **kw).numpy()

    def render_frames(self, *inputs, **kw):
        with reference_errors():
            for frame in self._port.render_frames(*inputs, device="cpu", **kw):
                yield frame.numpy()


def _compiler(port_compile, ref_compile):
    def compile_(source, *args, **kw):
        with reference_errors():
            port = port_compile(source, *args, **kw)
        return PortFilter(port, lambda: ref_compile(source, *args, **kw))

    return compile_


def port_api():
    """The `mm` stand-in: the reference's top-level names over the port."""
    api = types.SimpleNamespace(**{name: getattr(mm, name) for name in mm.__all__})
    api.compile = api.compile_source = _compiler(mt.compile_source, mm.compile_source)
    api.compile_file = _compiler(mt.compile_file, mm.compile_file)
    api.RenderOptions = mt.RenderOptions
    return api


def _parametrize(fn):
    """[(id, kwargs)] of a test function's stacked parametrize marks."""
    cases = [("", {})]
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        ids = mark.kwargs.get("ids")
        expanded = []
        for i, value in enumerate(values):
            value = getattr(value, "values", value)
            value = value if len(names) > 1 else (value,)
            label = (ids(value[0]) if callable(ids) else str(ids[i])) if ids else \
                "-".join(str(v) for v in value)
            expanded.append((label, dict(zip(names, value))))
        cases = [(f"{a}-{b}" if a else b, {**ka, **kb}) for a, ka in cases for b, kb in expanded]
    return cases


def reference_cases(module, left_out):
    """(case id, test function, parametrize kwargs) for every test of a
    reference test module but those named in `left_out`."""
    out = []
    for name in sorted(vars(module)):
        fn = getattr(module, name)
        if not name.startswith("test_") or not callable(fn) or name in left_out:
            continue
        for label, kwargs in _parametrize(fn):
            out.append((f"{name}[{label}]" if label else name, fn, kwargs))
    return out


def run_case(module, fn, kwargs, monkeypatch, **fixtures):
    """Run one reference test function with `mm` (and any error classes it
    imported by name) resolving to the port."""
    monkeypatch.setattr(module, "mm", port_api())
    code = fn.__code__
    wanted = code.co_varnames[:code.co_argcount]
    fn(**kwargs, **{k: v for k, v in fixtures.items() if k in wanted and k not in kwargs})
