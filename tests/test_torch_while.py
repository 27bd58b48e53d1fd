"""The port's `while` loops on the CPU against the reference, and kernel
B3's generator.

- Loop sources of tests/test_language.py (the in-VMEM engine's tests) and
  loop semantics (condition assignments, the max_loop_iters cap, do-while,
  internal-named loop variables, the entry errors) render through the port
  like the NumPy oracle (`interpret=True`), rtol=1e-4, atol=1e-5; the
  mandelbrot body's iteration grid equals the JAX engine's in interpret mode.
- Each library loop filter takes the reference's route
  (tests/test_loop_engines.py, its "lax" read as the port's "kernel").
- The generator: every builtin a kernel body may call, under each tag
  overload, traces into an SSA list whose torch interpreter, stepped under
  the mask, equals the eager loop exactly (the same torch ops), and whose
  CUDA spelling exists; the mandelbrot source bakes no param value.
"""

import os

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.kernels import while_loop as WL
from mathmap_tpu_torch.ops.rand import rand_index
from mathmap_tpu_torch.runtime import loops, tracer
from mathmap_tpu_torch.utils.trace import counter, since, snapshot
from test_torch_cuda import GENERATOR_BODIES, generator_source

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL, ATOL = 1e-4, 1e-5


def _zeros(h, w):
    return np.zeros((h, w, 4), np.float32)


def _both(src, h, w, options=None, params=None, t=0.0):
    """(port render, oracle render) of `src` on a blank input."""
    img = _zeros(h, w)
    ref = mm.compile(src).render(img, width=w, height=h, t=t, interpret=True,
                                 options=mm.RenderOptions(**(options or {})),
                                 params=params or {})
    got = mt.compile_source(src).render(img, width=w, height=h, t=t, device="cpu",
                                        options=mt.RenderOptions(**(options or {})),
                                        params=params or {})
    return got.numpy(), ref


def _loop_counters(f, *inputs, **kw) -> dict:
    """The `loop.*` counters one CPU render adds: {name less `loop.`: n}."""
    before = snapshot()
    f.render(*inputs, device="cpu", **kw)
    return {name[len("loop."):]: n for name, n in since(before)["counters"].items()
            if name.startswith("loop.")}


def _routes(f, *inputs, **kw) -> dict:
    """The routes of one CPU render's loops: {route: runs}."""
    return {name: n for name, n in _loop_counters(f, *inputs, **kw).items()
            if not name.endswith(".steps")}


# ----------------------------------------------------------------------
# tests/test_language.py's engine sources, through the port
# ----------------------------------------------------------------------

ENGINE_SOURCES = {
    # `x * 0` keeps the condition per pixel, so the static unroll passes
    "mul_add": ("i = 0; acc = 0;"
                "while i + x * 0 < 4 do acc = acc + 0.1 * i * (x / W); i = i + 1 end;"
                "grayColor(acc / 8)"),
    # atan2() is outside SAFE_CALLS: the masked loop, as the reference's
    # XLA loop
    "atan2": ("i = 0; acc = 0;"
              "while i + x * 0 < 4 do acc = acc + atan2(y, x + 10 + i); i = i + 1 end;"
              "grayColor(acc / 8)"),
    "cond_assign": ("c = x / W + y / H;"
                    "z = 0; i = 0; n = 0;"
                    "while n = n + 1; z < 4 + c && i < 37 do"
                    "  z = z + 0.2 + 0.1 * sin(c * 9 + i); i = i + 1 "
                    "end;"
                    "grayColor(clamp(z / 8 + i / 100 + n / 1000, 0, 1))"),
    "mandelbrot": ("c = ri:[x / X * 2.4 - 0.5, y / X * 2.4];"
                   "z = ri:[0, 0]; iter = 0;"
                   "while z[0]*z[0] + z[1]*z[1] < 4 && iter < 48 do"
                   "  z = z * z + c; iter = iter + 1 "
                   "end;"
                   "grayColor(iter / 48)"),
    "scalar_dep": ("filter f (float lim: 1-64 (20), float stepv: 0.01-1 (0.3))"
                   "  z = 0; i = 0;"
                   "  while z < lim && i < 100 do z = z + stepv; i = i + 1 end;"
                   "  grayColor(clamp(i / 100, 0, 1)) end"),
}


@pytest.mark.parametrize("size", [(16, 256), (13, 100)], ids=["16x256", "13x100"])
@pytest.mark.parametrize("name", sorted(ENGINE_SOURCES))
def test_engine_sources_match_the_oracle(name, size):
    h, w = size
    params = {"lim": 13.0, "stepv": 0.25} if name == "scalar_dep" else None
    got, ref = _both(ENGINE_SOURCES[name], h, w, params=params)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    f = mt.compile_source(ENGINE_SOURCES[name])
    route = "masked" if name == "atan2" else "kernel"
    assert _routes(f, _zeros(h, w), width=w, height=h, params=params or {}) == {route: 1}


def test_the_cap_applies_exactly():
    got, ref = _both(ENGINE_SOURCES["cond_assign"], 16, 256, options={"max_loop_iters": 9})
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    got, ref = _both("i = 0; while 1 do i = i + 1 end; grayColor(i / 10)", 4, 8,
                     options={"max_loop_iters": 5})
    np.testing.assert_array_equal(got[..., 0], np.full((4, 8), 0.5, np.float32))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_mandelbrot_body_equals_the_jax_engine_in_interpret_mode():
    """The reference's in-VMEM engine (forced, Pallas interpret mode on the
    CPU) and the port give the same iteration count at every pixel."""
    h, w = 16, 256
    src = ENGINE_SOURCES["mandelbrot"]
    jax_engine = mm.compile(src).render(
        _zeros(h, w), width=w, height=h,
        options=mm.RenderOptions(sampler="pallas", pallas_while="on"))
    got = mt.compile_source(src).render(_zeros(h, w), width=w, height=h, device="cpu")
    np.testing.assert_array_equal(np.round(got.numpy()[..., 0] * 48),
                                  np.round(np.asarray(jax_engine)[..., 0] * 48))


def test_rand_in_a_loop_is_not_ported():
    """Once refused (ROADMAP A3): a loop that draws now takes the kernel
    route and draws what the oracle draws, step by step
    (tests/test_torch_rand.py holds every route)."""
    src = ("s = 0; i = 0;"
           "while i + x * 0 < 6 do s = s + rand(0, 1); i = i + 1 end;"
           "grayColor(s / 6)")
    got, ref = _both(src, 13, 100)
    np.testing.assert_array_equal(got, ref)
    assert _routes(mt.compile_source(src), _zeros(13, 100)) == {"kernel": 1}


# ----------------------------------------------------------------------
# loop semantics against the oracle
# ----------------------------------------------------------------------

SEMANTICS = {
    "do_while": ("i = 0; s = x; do s = s * 0.5; i = i + 1 while i < 3 + x * 0 end;"
                 "grayColor(s / 8 + i / 10)"),
    "do_while_once": "i = 5; do i = i + 1 while i < 3 end; grayColor(i / 10)",
    "internal_y": "i = 0; while i < 3 + x * 0 do y = y * 0.5 + 1; i = i + 1 end; grayColor(y / 8)",
    "internal_t_xy": ("i = 0; while i < 2 + x * 0 do t = t + 1; q = y[0]; y = xy; i = i + 1 end;"
                      "grayColor(t / 8 + q / 100)"),
    "static_unroll": "s = 0; i = 0; while i < 5 do s = s + x * i; i = i + 1 end; grayColor(s / 40)",
    "nested": ("s = 0; i = 0; while i < 3 + x * 0 do j = 0;"
               "  while j < i + y * 0 do s = s + 1; j = j + 1 end; i = i + 1 end;"
               "grayColor(s / 4)"),
    "if_in_body": ("i = 0; s = 0; while i < 6 + x * 0 do if i % 2 == 0 then s = s + x else s = s - y end;"
                   " i = i + 1 end; grayColor(s / 50)"),
    "tuple_carry": ("v = xy; i = 0; while i < 4 + x * 0 do v = v * 0.5 + [1, 2]; i = i + 1 end;"
                    "rgbaColor(v[0] / 4, v[1] / 4, 0, 1)"),
}


@pytest.mark.parametrize("name", sorted(SEMANTICS))
def test_loop_semantics_match_the_oracle(name):
    got, ref = _both(SEMANTICS[name], 12, 20, t=0.3)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_pallas_while_modes_render_alike(mode):
    got, ref = _both(SEMANTICS["if_in_body"], 12, 20, options={"pallas_while": mode})
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


ERRORS = {
    "widen": ("v = xy; i = 0; while i < 2 do v = [1, 2, 3]; i = i + 1 end; grayColor(v[0])",
              "changes tuple length 2 -> 3"),
    "length": ("v = 0; i = 0; while i < 2 + x * 0 do v = [v, 1]; i = i + 1 end; grayColor(0)",
               "expected a single value"),
    "opaque_entry": ("filter f (image in, gradient g) q = g; i = 0; while i < 2 do q = g; i = i + 1 end;"
                     " grayColor(0) end", "cannot be loop variables"),
    "opaque_body": ("filter f (image in, gradient g) i = 0; while i < 2 do q = g; i = i + 1 end;"
                    " grayColor(0) end", "cannot be loop variables"),
    "image_body": ("i = 0; while i < 2 do q = in; i = i + 1 end; grayColor(0)",
                   "cannot be loop variables"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_loop_errors_match_the_reference(name):
    src, msg = ERRORS[name]
    with pytest.raises(mm.MMTypeError, match=msg):
        mm.compile(src).render(_zeros(8, 12), interpret=True)
    with pytest.raises(mt.MMTypeError, match=msg):
        mt.compile_source(src).render(_zeros(8, 12), device="cpu")


# ----------------------------------------------------------------------
# routes
# ----------------------------------------------------------------------

#: tests/test_loop_engines.py's expectation for the loop filters the port
#: renders, with the reference's "lax" read as "kernel" (the loop is
#: eligible); tricorn may take either
LIBRARY_ROUTES = {
    "Distorts/do_while_demo": {"kernel"},
    "Render/biomorph": {"kernel"},
    "Render/burning_ship": {"kernel"},
    "Render/julia": {"kernel"},
    "Render/lissajous": {"unroll"},
    "Render/mandelbrot": {"kernel"},
    "Render/newton": {"unroll"},
    "Render/quat_julia": {"kernel"},
    "Render/sierpinski": {"unroll"},
    "Render/tricorn": {"unroll", "kernel"},
}


@pytest.mark.parametrize("rel", sorted(LIBRARY_ROUTES))
def test_library_loops_take_the_reference_route(rel):
    f = mt.compile_file(os.path.join(ROOT, "filters", rel + ".mm"))
    n_img = sum(1 for p in f.fdef.params if p.kind == "image")
    img = np.random.RandomState(0).rand(24, 48, 4).astype(np.float32)
    routes = _routes(f, *([img] * n_img), width=48, height=24, t=0.37)
    assert routes and set(routes) <= LIBRARY_ROUTES[rel]


def test_on_forces_the_kernel_over_the_unroll_and_off_masks():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", "lissajous.mm"))
    assert _routes(f, width=16, height=8,
                   options=mt.RenderOptions(pallas_while="on")) == {"kernel": 1}
    assert _routes(f, width=16, height=8,
                   options=mt.RenderOptions(pallas_while="off")) == {"unroll": 1}
    assert _routes(f, width=16, height=8,
                   options=mt.RenderOptions(pallas_while="off", while_static_unroll=0)) == {"masked": 1}
    g = mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm"))
    assert _routes(g, width=16, height=8,
                   options=mt.RenderOptions(pallas_while="off")) == {"masked": 1}


#: lissajous's 64-step loop: options -> the `loop.*` counters of one render
LOOP_COUNTERS = {
    "kernel": (dict(pallas_while="on"), {"kernel": 1, "kernel.steps": 10000}),
    "kernel_bound": (dict(pallas_while="on", max_loop_iters=50),
                     {"kernel": 1, "kernel.steps": 50}),
    "unroll": (dict(pallas_while="off"), {"unroll": 1, "unroll.steps": 64}),
    "masked": (dict(pallas_while="off", while_static_unroll=0),
               {"masked": 1, "masked.steps": 64}),
}


@pytest.mark.parametrize("case", sorted(LOOP_COUNTERS))
def test_a_library_loop_counts_its_route_and_steps(case):
    """Each loop run adds 1 to `loop.<route>` and its steps to
    `loop.<route>.steps`; the kernel, whose steps run on the device, adds
    its bound, max_loop_iters."""
    options, want = LOOP_COUNTERS[case]
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", "lissajous.mm"))
    assert _loop_counters(f, width=16, height=8, options=mt.RenderOptions(**options)) == want


@pytest.mark.parametrize("src", [
    "s = 0; i = 0; while i < 3 + x * 0 do s = s + atan(y); i = i + 1 end; grayColor(s)",
    "s = 0; i = 0; while i < 3 + x * 0 do s = s + in(xy)[0]; i = i + 1 end; grayColor(s)",
    "filter f (image in, curve sin) s = 0; i = 0; while i < 3 + x * 0 do s = s + sin(0.5); i = i + 1 end; grayColor(s) end",
    SEMANTICS["nested"],
], ids=["unsafe_builtin", "image", "shadowed", "nested"])
def test_ineligible_loops_run_masked(src):
    f = mt.compile_source(src)
    routes = _routes(f, _zeros(6, 10))
    # the nest: its probe's inner loop takes the kernel; the outer loop and
    # the inner loops of its four steps (salted by the outer one) run masked
    assert routes == ({"kernel": 1, "masked": 5} if src == SEMANTICS["nested"]
                      else {"masked": 1})
    np.testing.assert_allclose(f.render(_zeros(6, 10), device="cpu").numpy(),
                               mm.compile(src).render(_zeros(6, 10), interpret=True),
                               rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# the generator
# ----------------------------------------------------------------------

def _capture(f, *inputs, **kw):
    """The loop-kernel calls of one CPU render: (loop, flat0, mask0, max_iters)."""
    calls = []
    orig = tracer.loop_kernel

    def spy(loop, flat0, mask0, max_iters):
        calls.append((loop, flat0, mask0, max_iters))
        return orig(loop, flat0, mask0, max_iters)

    tracer.loop_kernel = spy
    try:
        f.render(*inputs, device="cpu", **kw)
    finally:
        tracer.loop_kernel = orig
    return calls


def _interpret_loop(prog, loop, flat0, mask0, max_iters):
    """The Program stepped under the mask, as the kernel runs it per pixel."""
    values = {("x",): loop.x, ("y",): loop.y}
    values.update({("dep", n, j): a for n, tv in loop.deps for j, a in enumerate(tv.arrays)})
    values.update({k: torch.tensor(loops.scalar_internal(loop.ctx, k[1]), dtype=torch.float32)
                   for k in prog.scalar_inputs})
    flat, mask = flat0, mask0
    ctx = loop.ctx
    index = rand_index(ctx.shape, ctx.width, ctx.row_offset, ctx.col_offset, ctx.device)
    for it in range(max_iters):
        if not bool(mask.any()):
            break
        values.update({("carry", k): a for k, a in enumerate(flat)})
        outs, cond = WL.run_program(prog, values, "cpu",
                                    rand=(index, loop.rand_salt, loop.it_base + it + 1))
        flat = tuple(torch.where(mask, o, a) for o, a in zip(outs, flat))
        mask = mask & cond
    return flat


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _check_generated(f, *inputs, **kw):
    calls = _capture(f, *inputs, **kw)
    assert calls, "no loop reached the kernel route"
    for loop, flat0, mask0, max_iters in calls:
        prog = tracer.trace(loop, len(flat0))
        want, _ = WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                          loop.it_base)
        got = _interpret_loop(prog, loop, flat0, mask0, max_iters)
        assert all(_same(g, w) for g, w in zip(got, want))
        assert "while_loop_kernel" in WL.emit_cuda(prog, loop.origin)
    return calls


#: the loop bodies per builtin and tag overload (shared with the card's
#: tests, which run the same bodies through the compiled kernels)
BODIES = GENERATOR_BODIES


@pytest.mark.parametrize("name", sorted(BODIES))
def test_generated_program_equals_the_eager_loop(name):
    f = mt.compile_source(generator_source(BODIES[name]))
    (loop, *_), = _check_generated(f, width=20, height=12, t=0.3, frame=2.0)
    assert loops.eligible(loop.node, {}, f.filters)


def test_the_builtin_bodies_cover_the_admitted_builtins():
    from mathmap_tpu_torch.lang.parser import parse
    called = set()
    for body in BODIES.values():
        prog = parse(f"filter f () {body}; grayColor(0) end")
        called |= {n.func.name for n in mt.lang.astnodes.walk(prog)
                   if isinstance(n, mt.lang.astnodes.Call)}
    operators = {n for n in WL.SAFE_CALLS if n.startswith("__")}
    assert WL.SAFE_CALLS - operators <= called


#: one non-default param set per fractal (inside each declared range)
FRACTAL_PARAMS = {
    "mandelbrot": {"maxiter": 40, "zoom": 2.0, "cx": -0.7},
    "julia": {"maxiter": 40, "cre": -0.4, "cim": 0.6},
    "burning_ship": {"maxiter": 40, "zoom": 1.5},
    "tricorn": {"maxiter": 40, "zoom": 1.3},
    "biomorph": {"maxiter": 40, "cre": 0.3},
    "quat_julia": {"maxiter": 40, "cw": -0.2, "cx2": 0.6},
}


@pytest.mark.parametrize("name", sorted(FRACTAL_PARAMS))
def test_fractal_programs_equal_the_eager_loop(name):
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", f"{name}.mm"))
    _check_generated(f, width=64, height=48)
    _check_generated(f, width=64, height=48, params=FRACTAL_PARAMS[name])


def test_generated_source_bakes_no_param_value():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm"))
    params = {"maxiter": 77, "zoom": 1.37, "cx": -0.613, "cy": 0.271}
    (loop, flat0, *_), = _capture(f, width=24, height=16, params=params, t=0.45)
    src = WL.emit_cuda(tracer.trace(loop, len(flat0)), loop.origin)
    for v in (77.0, 1.37, -0.613, 0.271, 0.45, 12.0, 8.0):
        assert float(np.float32(v)).hex() not in src, v
    (loop2, flat2, *_), = _capture(f, width=40, height=30, params={"maxiter": 500})
    assert WL.emit_cuda(tracer.trace(loop2, len(flat2)), loop2.origin) == src


def test_scalar_internals_are_kernel_arguments():
    f = mt.compile_source("filter f () i = 0; while i + x * 0 < 2 do i = i + t + W / 100; end; grayColor(i) end")
    (loop, flat0, *_), = _capture(f, width=24, height=16, t=0.25)
    prog = tracer.trace(loop, len(flat0))
    assert prog.scalar_inputs == [("scalar", "t"), ("scalar", "W")]


def test_float_literals_are_exact_hex():
    assert WL._f32(0.1) == float(np.float32(0.1)).hex() + "f"
    assert WL._f32(-2.5) == "(-0x1.4000000000000p+1f)"
    assert WL._f32(float("inf")).startswith("__int_as_float")
    assert WL._f32(float("nan")).startswith("__int_as_float")


def test_python_scalar_pow_is_refused():
    prog = WL.Program()
    v = prog.input(("x",))
    with pytest.raises(WL.GeneratorError):
        WL.emit_cuda(_with_outputs(prog, v ** 2.0, v > 0))


def _with_outputs(prog, out, cond):
    prog.outputs = [prog.operand(out)]
    prog.cond = prog.operand(cond)
    return prog


def test_a_traced_value_cannot_drive_python_control_flow():
    prog = WL.Program()
    with pytest.raises(WL.GeneratorError):
        bool(prog.input(("x",)) > 0)


def test_cpu_loops_never_count_launches():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm"))
    before = counter("launch.while_loop")
    f.render(width=16, height=8, device="cpu")
    assert counter("launch.while_loop") == before
