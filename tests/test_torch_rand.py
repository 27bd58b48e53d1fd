"""rand() through the port on the CPU, against the JAX package's NumPy
oracle (`interpret=True`):

- the hash (ops/rand.py) equals the oracle Evaluator's `rand_uniform` bit
  for bit over seeds, counters, tile offsets, loop salts and nested
  `_mix_salt` values up to 2^32 - 1, the values whose int64 products would
  overflow without the negative representatives;
- the library entries that draw (dissolve, film_grain, jitter,
  night_vision, sparkle, stars, static_tv, truchet) at 64x48 at two seeds
  and with supersample=2, rtol=1e-4, atol=1e-5; every subsample draws
  fresh counters;
- static_tv and jitter through render_tiled on (1,8,1) and (1,2,4) CPU
  meshes and through render_sharded equal the unsharded port render and
  the reference's on its 8 virtual devices;
- loops that draw (rand_walk, the reference fuzz generator's rand class)
  on every route, each route asserted, and the unroll that goes on from
  its last step; kernel B3's op list against the eager step; the kernel
  source's hash constants, and no rebuild for another seed or frame size.
"""

import jax
import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mathmap_tpu.runtime import tracer as ref_tracer
from mathmap_tpu_torch.kernels import while_loop as WL
from mathmap_tpu_torch.ops import rand as RND
from mathmap_tpu_torch.runtime import tracer
from test_fuzz import ExprGen
from test_torch_render import LIBRARY, _library_filter
from test_torch_while import _capture, _check_generated, _routes

RTOL, ATOL = 1e-4, 1e-5
W, H = 64, 48

#: a per-pixel trip count that draws: `auto` takes kernel B3 after the
#: static unroll's first step
RAND_WALK = ("s = 0; i = 0; while s < 1 && i < 64 do s = s + rand(0, 0.1) * (1 + x / W);"
             " i = i + 1 end; grayColor(i / 64)")


def _image(seed, h=H, w=W):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


# ----------------------------------------------------------------------
# the hash
# ----------------------------------------------------------------------

#: (seed, counter, (rows, cols), (row_offset, col_offset), frame width,
#: salt_extra) against the oracle Evaluator
HASH_CASES = [
    (0, 1, (16, 20), (0, 0), 20, None),
    (7, 3, (16, 20), (0, 0), 20, 1),
    (123456789, 1000003 * 5 + 2, (6, 64), (18, 0), 64, 9999),
    (-3, 17, (24, 16), (24, 48), 64, 2**31),
    (2**33 + 5, 2**40 + 1, (5, 7), (3, 1000), 4000, 2**32 - 1),
    (1, 0, (8, 8), (2**15, 2**15), 2**16 + 3, 0x80000001),
    (0, 2, (4, 3840), (2156, 0), 3840, 77),
]


def _oracle_draw(seed, counter, shape, offsets, width, salt_extra):
    ctx = ref_tracer.RenderContext(
        be=np, width=width, height=offsets[0] + shape[0], opts=mm.RenderOptions(seed=seed),
        is_jax=False, grid_shape=shape, row_offset=offsets[0], col_offset=offsets[1],
        rand_counter=counter - 1)
    extra = None if salt_extra is None else np.uint32(salt_extra)
    ev = ref_tracer.Evaluator(ctx, None, None, {}, salt_extra=extra)
    return ev.rand_uniform()


@pytest.mark.parametrize("case", range(len(HASH_CASES)))
def test_rand_uniform_is_the_oracle_bit_for_bit(case):
    seed, counter, shape, offsets, width, salt_extra = HASH_CASES[case]
    want = _oracle_draw(*HASH_CASES[case])
    index = RND.rand_index(shape, width, *offsets, "cpu")
    got = RND.rand_uniform(index, RND.draw_salt(seed, counter), salt_extra)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the evaluator's own draw is the same function
    ctx = tracer.RenderContext(device=torch.device("cpu"), width=width,
                               height=offsets[0] + shape[0], opts=mt.RenderOptions(seed=seed),
                               grid_shape=shape, row_offset=offsets[0], col_offset=offsets[1],
                               rand_counter=counter - 1)
    drawn = tracer.Evaluator(ctx, None, None, {}, salt_extra).rand_uniform()
    assert ctx.rand_counter == counter
    assert torch.equal(drawn, got)


@pytest.mark.parametrize("outer,inner", [(1, 1), (2**31, 3), (2**32 - 1, 2**32 - 1),
                                         (0x9E3779B9, 10000), (12345, 2**31 + 7)])
def test_nested_loop_salts_are_the_oracles(outer, inner):
    """_mix_salt of a loop inside a loop, then a draw with it: the products
    pass 2^63 before the mask, where int64 arithmetic would overflow."""
    ctx = ref_tracer.RenderContext(be=np, width=8, height=4, opts=mm.RenderOptions(),
                                   is_jax=False)
    ev = ref_tracer.Evaluator(ctx, None, None, {}, salt_extra=np.uint32(outer))
    with np.errstate(over="ignore"):
        want = int(ev._mix_salt(np.uint32(inner)))
    assert RND.mix_salt(outer, inner) == want
    port = tracer.Evaluator(tracer.RenderContext(torch.device("cpu"), 8, 4, mt.RenderOptions()),
                            None, None, {}, outer)
    assert port._mix_salt(inner) == want
    assert tracer.Evaluator(port.ctx, None, None, {})._mix_salt(inner) == inner
    np.testing.assert_array_equal(
        RND.rand_uniform(RND.rand_index((4, 8), 8, 0, 0, "cpu"), RND.draw_salt(5, 2), want)
        .numpy().view(np.int32),
        _oracle_draw(5, 2, (4, 8), (0, 0), 8, want).view(np.int32))


def test_draws_are_uniform_and_exact_multiples_of_2_to_the_minus_24():
    u = RND.rand_uniform(RND.rand_index((256, 256), 256, 0, 0, "cpu"), RND.draw_salt(0, 1))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u * 2**24, torch.floor(u * 2**24))


# ----------------------------------------------------------------------
# the library entries that draw
# ----------------------------------------------------------------------

RAND_ENTRIES = ("dissolve", "film_grain", "jitter", "night_vision", "sparkle", "stars",
                "static_tv", "truchet")
#: (seed, supersample) per case
RENDER_CASES = {"seed0": (0, 1), "seed7": (7, 1), "supersample2": (0, 2)}


def render_against_oracle(name, seed, supersample):
    """(port render, oracle render) of a library entry at 64x48, t=0.3."""
    path, _program, _fdef = LIBRARY[name]
    port = _library_filter(name)
    inputs = [_image(20 + i) for i, p in enumerate(
        p for p in port.fdef.params if p.kind == "image")]
    opts = dict(seed=seed, supersample=supersample)
    want = mm.compile_file(path, main=name).render(
        *inputs, width=W, height=H, t=0.3, options=mm.RenderOptions(**opts), interpret=True)
    got = port.render(*inputs, width=W, height=H, t=0.3, options=mt.RenderOptions(**opts),
                      device="cpu")
    return got.numpy(), want


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
@pytest.mark.parametrize("name", RAND_ENTRIES)
def test_rand_entries_match_the_oracle(name, case):
    got, want = render_against_oracle(name, *RENDER_CASES[case])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_seed_changes_the_draws():
    f = mt.compile_source("grayColor(rand(0, 1))")
    a, b = (f.render(_image(0, 8, 16), device="cpu", options=mt.RenderOptions(seed=s))
            for s in (0, 1))
    assert not torch.equal(a, b)


def test_each_subsample_draws_fresh_counters():
    """The grid supersampling loop shares one context across subsamples, so
    each draws the next counter: the average of four draws, as the
    oracle's, not one draw four times."""
    src = "grayColor(rand(0, 1))"
    f = mt.compile_source(src)
    img = _image(1, 8, 16)
    one = f.render(img, device="cpu").numpy()
    four = f.render(img, device="cpu", options=mt.RenderOptions(supersample=2)).numpy()
    want = mm.compile(src).render(img, interpret=True,
                                  options=mm.RenderOptions(supersample=2))
    np.testing.assert_array_equal(four, want)
    assert not np.array_equal(one, four)
    # and the average of the four single-counter draws
    index = RND.rand_index((8, 16), 16, 0, 0, "cpu")
    draws = [RND.rand_uniform(index, RND.draw_salt(0, c)) for c in (1, 2, 3, 4)]
    acc = draws[0]
    for d in draws[1:]:
        acc = acc + d
    np.testing.assert_array_equal(four[..., 0], torch.clamp(acc * 0.25, 0, 1).numpy())


# ----------------------------------------------------------------------
# tiled and sharded
# ----------------------------------------------------------------------

MESHES = ((1, 8, 1), (1, 2, 4))


def _ref_mesh(shape):
    return ref_make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


def _port_mesh(shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("entry", ["render_tiled", "render_sharded"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["static_tv", "jitter"])
def test_tiled_and_sharded_draws_equal_the_unsharded_render(name, mesh_shape, entry):
    path, _program, _fdef = LIBRARY[name]
    img = _image(31)
    # amount=3: the bound of its declared range (20) passes a 6-row tile
    size = dict(width=W, height=H, t=0.3, params={"amount": 3.0} if name == "jitter" else {})
    halo = {"halo": "auto"} if entry == "render_tiled" else {}
    port = _library_filter(name)
    opts = mt.RenderOptions(seed=3)
    got = getattr(port, entry)(img, mesh=_port_mesh(mesh_shape), options=opts, **halo, **size)
    unsharded = port.render(img, device="cpu", options=opts, **size)
    np.testing.assert_array_equal(got.numpy(), unsharded.numpy())
    ref = mm.compile_file(path, main=name)
    want = np.asarray(getattr(ref, entry)(img, mesh=_ref_mesh(mesh_shape),
                                          options=mm.RenderOptions(seed=3), **halo, **size))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# loops that draw
# ----------------------------------------------------------------------

def _rand_class_seeds():
    """Seeds of the reference fuzz generator's rand class (rand() in a
    loop whose condition assigns, and after it) whose body the kernel may
    run, and one whose body samples the input (never the kernel)."""
    seeds = [s for s in range(300) if "rand(" in ExprGen(s).program()]
    eligible = [s for s in seeds if "origVal" not in ExprGen(s).program()]
    return eligible[:3] + [s for s in seeds if s not in eligible][:1]


RAND_CLASS = _rand_class_seeds()
#: option fields -> the route each loop takes: rand_walk's per-pixel trip
#: count, and the rand class's literal bound (its eligible bodies)
ROUTES = {
    "off": (dict(pallas_while="off"), "masked", "unroll"),
    "auto": ({}, "kernel", "unroll"),
    "on": (dict(pallas_while="on"), "kernel", "kernel"),
    "unroll_then_continue": (dict(while_static_unroll=2), "kernel", "kernel"),
    "no_unroll": (dict(while_static_unroll=0), "kernel", "kernel"),
}


def _loop_sources():
    out = {"rand_walk": RAND_WALK}
    out.update({f"rand_class_{s}": ExprGen(s).program() for s in RAND_CLASS})
    return out


LOOP_SOURCES = _loop_sources()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(LOOP_SOURCES))
def test_loops_that_draw_match_the_oracle_on_every_route(name, route):
    src = LOOP_SOURCES[name]
    fields, walk_route, class_route = ROUTES[route]
    img = _image(40, 12, 10)
    want = mm.compile(src).render(img, interpret=True, options=mm.RenderOptions(**fields))
    f = mt.compile_source(src)
    routes = _routes(f, img, options=mt.RenderOptions(**fields))
    got = f.render(img, device="cpu", options=mt.RenderOptions(**fields)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=src)
    if name == "rand_walk":
        np.testing.assert_array_equal(got, want)
        assert routes == {walk_route: 1}
    elif "origVal" in src:
        # the body samples the input: no route takes the kernel
        budget_left = route not in ("unroll_then_continue", "no_unroll")
        assert routes == ({"unroll": 1} if budget_left else {"masked": 1})
    else:
        assert routes == {class_route: 1}


@pytest.mark.parametrize("fields", [{}, dict(while_static_unroll=0),
                                    dict(pallas_while="on", seed=11)],
                         ids=["unroll_then_continue", "no_unroll", "on_seed11"])
def test_rand_walk_program_equals_the_eager_step(fields):
    """Kernel B3's op list for rand_walk, stepped by run_program with the
    hash, equals the eager loop; its iterations are numbered after the
    unroll's."""
    f = mt.compile_source(RAND_WALK)
    calls = _check_generated(f, _image(2, 24, 40), options=mt.RenderOptions(**fields))
    (loop, *_), = calls
    assert loop.it_base == (1 if not fields else 0)
    ops = [op for op, _, _ in tracer.trace(loop, 2).ops]
    assert ops.count("rand") == 1
    # the draw counts as its hash's operations in the kernel's bound
    n_other = sum(op not in ("in", "const", "rand") for op in ops)
    assert tracer.trace(loop, 2).n_compute_ops() == n_other + WL.RAND_OPS


@pytest.mark.parametrize("seed", [s for s in RAND_CLASS if "origVal" not in ExprGen(s).program()])
def test_rand_class_programs_equal_the_eager_step(seed):
    f = mt.compile_source(ExprGen(seed).program())
    _check_generated(f, _image(3, 12, 10), options=mt.RenderOptions(pallas_while="on"))
    _check_generated(f, _image(3, 12, 10), options=mt.RenderOptions(while_static_unroll=2))


def test_a_loop_inside_a_loop_step_never_takes_the_kernel():
    """The reference's rule: a loop evaluated with an enclosing loop's salt
    stays off the kernel (only the probe's evaluation, outside any step,
    may take it)."""
    src = ("s = 0; i = 0; while i < 3 + x * 0 do j = 0;"
           "  while j < i + y * 0 do s = s + rand(0, 1); j = j + 1 end; i = i + 1 end;"
           "grayColor(s / 4)")
    img = _image(5, 8, 12)
    f = mt.compile_source(src)
    opts = mt.RenderOptions(pallas_while="on")
    # the probe's inner loop takes the kernel; the outer loop (a nest) and
    # the inner loops of its four steps run masked
    assert _routes(f, img, options=opts) == {"kernel": 1, "masked": 5}
    want = mm.compile(src).render(img, interpret=True)
    np.testing.assert_array_equal(f.render(img, device="cpu", options=opts).numpy(), want)


def test_sibling_loops_and_draws_after_a_loop_take_fresh_counters():
    src = ("a1 = 0; i = 0; while i < 3 + x * 0 do a1 = a1 + rand(0, 1); i = i + 1 end;"
           "a2 = 0; j = 0; while j < 3 + x * 0 do a2 = a2 + rand(0, 1); j = j + 1 end;"
           "rgbaColor(a1 / 3, a2 / 3, rand(0, 1), 1)")
    img = _image(6, 8, 12)
    got = mt.compile_source(src).render(img, device="cpu").numpy()
    want = mm.compile(src).render(img, interpret=True)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[..., 0], got[..., 1])


# ----------------------------------------------------------------------
# kernel B3's source
# ----------------------------------------------------------------------

def test_the_kernel_hash_has_the_evaluators_constants():
    tmpl = WL.TEMPLATE.read_text()
    for c in (RND.GOLDEN, RND.MIX1, RND.MIX2):
        assert f"0x{c:X}u" in tmpl, hex(c)
    assert "0x1p-24f" in tmpl


def test_a_seed_or_frame_size_does_not_rebuild():
    f = mt.compile_source(RAND_WALK)
    sources = set()
    for seed, (w, h) in ((0, (40, 24)), (9, (40, 24)), (0, (64, 32))):
        (loop, flat0, *_), = _capture(f, _image(0, h, w), options=mt.RenderOptions(seed=seed))
        src = WL.emit_cuda(tracer.trace(loop, len(flat0)), loop.origin)
        assert "mm_rand(rand_idx, rand_salt + 0x85ebca6bu, loop_i)" in src
        sources.add(src)
    assert len(sources) == 1
    # a subsample's loop starts from another nonce: the same source, another salt
    calls = _capture(f, _image(0, 8, 16), options=mt.RenderOptions(supersample=2))
    assert len({WL.emit_cuda(tracer.trace(c[0], 2), c[0].origin) for c in calls}) == 1
    assert len({c[0].rand_salt for c in calls}) == 4
