"""Animated (T, H, W, 4) inputs, `render_animation`, `render_frames` and the
mesh's frame axis of the port on the CPU: the cases of
tests/test_animated_inputs.py (all but the CLI's, which has no port yet),
each held against the reference's NumPy oracle (`interpret=True`) or, for
the mesh paths, against the JAX package's render on its 8 virtual CPU
devices, at rtol=1e-4, atol=1e-5 (identity samples exactly); the frame
index of NaN, ±inf and ±3e9 (the oracle's float32 -> int32 cast gives
INT_MIN there, so frame 0) on the Python-float, 0-d tensor and per-pixel
routes; and `render_sharded(num_frames=4, ts=...)` and an animated
`render_tiled` on CPU meshes against the JAX package's.

Semantics: indices round to nearest and clamp to [0, T-1]; origVal(xy) on
an animated input samples the render's current frame (animation in ->
animation out).
"""

import jax
import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mathmap_tpu_torch.convert import inputs_from_numpy, options_from_reference
from mathmap_tpu_torch.runtime.value import InputImage
from mathmap_tpu_torch.utils.trace import counter

H, W, T = 16, 64, 3
RTOL, ATOL = 1e-4, 1e-5
NEAREST = mm.RenderOptions(interpolation="nearest")


def _anim(seed=0, t=T, h=H, w=W):
    stack = np.random.RandomState(seed).rand(t, h, w, 4).astype(np.float32)
    stack[..., 3] = 1.0
    return stack


def _both(src):
    return mt.compile_source(src), mm.compile(src)


def _port_opts(ref_opts):
    return options_from_reference(ref_opts)


def ref_mesh(shape):
    return ref_make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


def port_mesh(shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def test_current_frame_sampling_identity():
    """origVal(xy) on an animated input returns the current frame."""
    stack = _anim()
    port, ref = _both("origVal(xy)")
    for fr in range(T):
        out = port.render(stack, frame=float(fr), options=_port_opts(NEAREST), device="cpu")
        np.testing.assert_array_equal(out.numpy(), stack[fr])
        np.testing.assert_array_equal(
            out.numpy(), ref.render(stack, frame=float(fr), options=NEAREST, interpret=True))


def test_explicit_frame_index_and_clamp():
    stack = _anim(1)
    port = mt.compile_source("origValXY(x, y, 1)")
    out = port.render(stack, options=_port_opts(NEAREST), device="cpu")
    np.testing.assert_array_equal(out.numpy(), stack[1])
    out2 = mt.compile_source("origValXY(x, y, 99)").render(
        stack, options=_port_opts(NEAREST), device="cpu")
    np.testing.assert_array_equal(out2.numpy(), stack[T - 1])


def test_per_pixel_frame_index_gather_path():
    """A per-pixel frame expression takes the two-axis gather, no kernel."""
    stack = _anim(2)
    port, ref = _both("origValXY(x, y, if x >= 0 then 2 else 0 end)")
    before = counter("launch.sample_image")
    out = port.render(stack, options=_port_opts(NEAREST), device="cpu").numpy()
    assert counter("launch.sample_image") == before
    right = (np.arange(W) + 0.5 - W / 2) >= 0
    np.testing.assert_array_equal(out[:, right], stack[2][:, right])
    np.testing.assert_array_equal(out[:, ~right], stack[0][:, ~right])
    np.testing.assert_array_equal(out, ref.render(stack, options=NEAREST, interpret=True))


PER_PIXEL_WARP = "origValXY(x * 0.9 + 1.3, y * 0.8 - 0.7, if x >= 0 then 2 else 0 end)"
GATHER_OPTS = [
    mm.RenderOptions(interpolation="nearest", edge_x="wrap", edge_y="reflect"),
    mm.RenderOptions(interpolation="bilinear", edge_x="color", edge_y="color",
                     edge_color=(1.0, 0.0, 0.0, 1.0)),
    mm.RenderOptions(interpolation="bicubic", edge_x="reflect", edge_y="wrap"),
]


@pytest.mark.parametrize("ropts", GATHER_OPTS, ids=lambda o: o.interpolation)
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_per_pixel_frame_gather_matches_the_oracle(ropts, u8):
    """A warped per-pixel frame selection (the port of the reference's
    `_sample_xla` over the two-axis gather) at each interpolation and edge
    behavior, f32 and u8 stacks, against the oracle; u8 taps convert /255
    exactly."""
    stack = _anim(11)
    if u8:
        stack = (stack * 255).astype(np.uint8)
    port, ref = _both(PER_PIXEL_WARP)
    got = port.render(stack, options=_port_opts(ropts), device="cpu")
    want = ref.render(stack, options=ropts, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ropts", GATHER_OPTS, ids=lambda o: o.interpolation)
def test_tiled_per_pixel_frame_gather_matches_the_reference(ropts):
    """The same warped per-pixel frame selection on an animated tiled input
    (the block's two-axis gather, localised to the block) on a (1, 4, 2)
    CPU mesh against the JAX package's tiled render on its 8 virtual
    devices and the port's unsharded render."""
    stack = _anim(12, h=64)
    port, ref = _both(PER_PIXEL_WARP)
    opts = _port_opts(ropts)
    got = port.render_tiled(stack, options=opts, mesh=port_mesh((1, 4, 2)))
    want = ref.render_tiled(stack, options=ropts, mesh=ref_mesh((1, 4, 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), port.render(stack, options=opts,
                                                        device="cpu").numpy(),
                               rtol=RTOL, atol=ATOL)


def test_tiled_per_pixel_frame_violation_check():
    """A per-pixel frame selection that reaches past the halo raises, as
    the reference does on its 8 virtual devices."""
    stack = _anim(13, h=64)
    src = "origValXY(x * 3, y * 3, if x >= 0 then 1 else 0 end)"
    port, ref = _both(src)
    with pytest.raises(mm.MMError, match="bounded-displacement"):
        ref.render_tiled(stack, halo=2, mesh=ref_mesh((1, 8, 1)))
    with pytest.raises(mt.MMError, match="bounded-displacement"):
        port.render_tiled(stack, halo=2, mesh=port_mesh((1, 8, 1)))


def test_oracle_parity_animated_warp():
    """A warp over an animated input, current-frame and explicit-frame
    sampling mixed, against the oracle."""
    stack = _anim(3)
    port, ref = _both("0.5 * origVal(xy * 0.8) + 0.5 * origValXY(x * 0.9, y, 0)")
    opts = mm.RenderOptions(interpolation="bilinear", edge_x="wrap", edge_y="reflect")
    got = port.render(stack, frame=2.0, options=_port_opts(opts), device="cpu")
    want = ref.render(stack, frame=2.0, options=opts, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_animation_in_animation_out():
    """render_animation over an animated input: frame f samples input frame
    f (num_frames == T, identity filter)."""
    stack = _anim(4)
    out = mt.compile_source("origVal(xy)").render_animation(
        stack, num_frames=T, options=_port_opts(NEAREST), device="cpu")
    np.testing.assert_array_equal(out.numpy(), stack)


def test_animated_pallas_matches_gather():
    """The kernel route (a scalar frame selects one frame, which the
    sampler takes as an image) equals the two-axis gather (a per-pixel
    frame plane of the same value) and the oracle."""
    stack = np.random.RandomState(5).rand(2, 64, 256, 4).astype(np.float32)
    scalar, ref = _both("origValXY(x * 0.9 + 3 * sin(y / 7), y * 1.1, 1)")
    plane = mt.compile_source("origValXY(x * 0.9 + 3 * sin(y / 7), y * 1.1, 1 + x * 0)")
    a = scalar.render(stack, device="cpu")
    b = plane.render(stack, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.numpy(), ref.render(stack, interpret=True), rtol=RTOL,
                               atol=ATOL)


def test_single_frame_stack_pallas_path():
    """(1, H, W, 4) stacks (single-frame GIFs stay 4-D) sample their one
    frame through the sampler."""
    stack = np.random.RandomState(6).rand(1, 32, 64, 4).astype(np.float32)
    before = counter("launch.sample_image")
    out = mt.compile_source("origVal(xy)").render(stack, options=_port_opts(NEAREST),
                                                  device="cpu")
    np.testing.assert_array_equal(out.numpy(), stack[0])
    assert counter("launch.sample_image") == before  # the CPU runs the plain version


def test_render_batch_input_validation():
    """render_batch: a lone (H,W,C) frame and a ts/batch length mismatch
    raise clear ValueErrors."""
    f = mt.compile_source("origVal(xy)")
    frame = np.zeros((16, 16, 4), np.float32)
    with pytest.raises(ValueError, match="leading batch axis"):
        f.render_batch(frame, device="cpu")
    with pytest.raises(ValueError, match="ts for a batch"):
        f.render_batch(np.stack([frame] * 3), ts=[0.1, 0.2], device="cpu")


def test_render_sharded_animated_matches_render():
    """render_sharded replicates animated stacks per device; the output
    equals the unsharded render frame for frame, and the JAX package's."""
    stack = _anim(3)
    port, ref = _both("filter f (image in) in(xy) end")
    for fr in (0.0, 2.0):
        want = port.render(stack, width=W, height=H, frame=fr, options=_port_opts(NEAREST),
                           device="cpu")
        out = port.render_sharded(stack, width=W, height=H, frame=fr,
                                  options=_port_opts(NEAREST), mesh=port_mesh((1, 8, 1)))
        assert torch.equal(out, want)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref.render_sharded(
            stack, width=W, height=H, frame=fr, options=NEAREST, mesh=ref_mesh((1, 8, 1)))))


def test_render_tiled_animated_matches_render():
    """Animated stacks under the tiled path: every frame shards alike;
    current-frame, explicit-scalar and per-pixel frame selection all equal
    the unsharded render."""
    stack = _anim(7)
    opts = _port_opts(NEAREST)
    mesh = port_mesh((1, 8, 1))
    f = mt.compile_source("filter f (image in) in(xy) end")
    for fr in (0.0, 2.0):
        want = f.render(stack, width=W, height=H, frame=fr, options=opts, device="cpu")
        out = f.render_tiled(stack, width=W, height=H, frame=fr, options=opts, mesh=mesh)
        assert torch.equal(out, want)
    for src in ("origValXY(x, y, 1)", "origValXY(x, y, if x >= 0 then 2 else 0 end)"):
        g = mt.compile_source(src)
        assert torch.equal(g.render_tiled(stack, width=W, height=H, options=opts, mesh=mesh),
                           g.render(stack, width=W, height=H, options=opts, device="cpu"))


@pytest.mark.parametrize("edges", ["wrap_reflect", "color"])
def test_render_tiled_animated_warp_and_edges(edges):
    """Warped sampling over an animated tiled input exercises the halo
    exchange and edge painting on the 4-D stack (wrap/reflect and color),
    against the unsharded render and the JAX package's tiled render."""
    stack = np.random.RandomState(8).rand(3, 64, W, 4).astype(np.float32)
    port, ref = _both("filter f (image in) in(xy + xy:[2, -3]) end")
    ropts = (mm.RenderOptions(interpolation="bilinear", edge_x="wrap", edge_y="reflect")
             if edges == "wrap_reflect" else
             mm.RenderOptions(interpolation="bilinear", edge_x="color", edge_y="color",
                              edge_color=(1.0, 0.0, 0.0, 1.0)))
    opts = _port_opts(ropts)
    want = port.render(stack, width=W, height=64, frame=2.0, options=opts, device="cpu")
    out = port.render_tiled(stack, width=W, height=64, frame=2.0, options=opts,
                            mesh=port_mesh((1, 8, 1)))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.render_tiled(
        stack, width=W, height=64, frame=2.0, options=ropts, mesh=ref_mesh((1, 8, 1)))),
        rtol=RTOL, atol=ATOL)


def test_render_tiled_animated_violation_check():
    """The bounded-displacement contract still raises on animated inputs."""
    stack = np.random.RandomState(9).rand(2, 64, W, 4).astype(np.float32)
    f = mt.compile_source("filter f (image in) in(xy * 3) end")
    with pytest.raises(mt.MMError, match="bounded-displacement"):
        f.render_tiled(stack, width=W, height=64, halo=2, mesh=port_mesh((1, 8, 1)))


def test_uint8_image_userval_normalizes():
    """A uint8 array bound to an image PARAM normalises /255 exactly like a
    positional input, and an animated one too."""
    f32 = _anim(5)
    u8 = (np.clip(f32, 0, 1) * 255 + 0.5).astype(np.uint8)
    port, ref = _both("filter f (image img) img(xy) end")
    opts = _port_opts(NEAREST)
    a = port.render(width=W, height=H, params={"img": u8[0]}, options=opts, device="cpu")
    b = port.render(width=W, height=H, params={"img": u8[0].astype(np.float32) / 255.0},
                    options=opts, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert float(a.max()) <= 1.0
    np.testing.assert_array_equal(a.numpy(), ref.render(
        width=W, height=H, params={"img": u8[0]}, options=NEAREST, interpret=True))
    c = port.render(width=W, height=H, frame=2.0, params={"img": u8}, options=opts,
                    device="cpu")
    np.testing.assert_array_equal(c.numpy(), ref.render(
        width=W, height=H, frame=2.0, params={"img": u8}, options=NEAREST, interpret=True))


def test_render_sharded_frame_sweep_animated():
    """A sharded multi-frame sweep over an animated input: output frame i
    samples input frame i (the frame internal is the sweep index)."""
    stack = _anim(11)
    f = mt.compile_source("filter f (image in) in(xy) end")
    opts = _port_opts(NEAREST)
    out = f.render_sharded(stack, num_frames=T, width=W, height=H, options=opts,
                           mesh=port_mesh((1, 2, 1)))
    np.testing.assert_array_equal(out.numpy(), stack)


#: frame values and the routes that select a frame from them
FRAME_VALUES = (float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 2**31, 5.4, 1.5, -0.6)
FRAME_ROUTES = {
    "frame": ("origVal(xy)", lambda v: dict(frame=v)),
    "scalar": ("origValXY(x, y, t)", lambda v: dict(t=v)),
    "plane": ("origValXY(x, y, t + x * 0)", lambda v: dict(t=v)),
}


@pytest.mark.parametrize("route", sorted(FRAME_ROUTES))
def test_frame_index_casts_match_the_oracle(route):
    """NaN, ±inf and values outside int32 cast to INT_MIN in the oracle's
    NumPy, so they select frame 0 after the clip (CUDA's conversion would
    saturate to frame T-1): the port maps them in float before any cast."""
    stack = _anim(12, t=8)
    src, kw = FRAME_ROUTES[route]
    port, ref = _both(src)
    for v in FRAME_VALUES:
        got = port.render(stack, options=_port_opts(NEAREST), device="cpu", **kw(v))
        with np.errstate(invalid="ignore"):  # the oracle's cast of NaN and inf
            want = ref.render(stack, options=NEAREST, interpret=True, **kw(v))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame value {v}")
    with np.errstate(invalid="ignore"):
        want_index = np.clip(np.floor(np.float32(FRAME_VALUES) + np.float32(0.5))
                             .astype(np.int32), 0, 7)
    img = InputImage(pixels=torch.from_numpy(stack))
    assert [img.frame_index(v) for v in FRAME_VALUES] == want_index.tolist()
    grid = img.frame_index(torch.tensor(FRAME_VALUES, dtype=torch.float32))
    assert grid.tolist() == want_index.tolist()


SWEEP_MESHES = ((4, 2, 1), (2, 2, 2), (1, 8, 1))


@pytest.mark.parametrize("mesh_shape", SWEEP_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_render_sharded_sweep_matches_the_reference(mesh_shape):
    """render_sharded(num_frames=4, ts=...) splits the frames over the
    frame axis in contiguous blocks: each frame at t = ts[i] with frame
    internal i, as the JAX package renders it on its 8 virtual devices."""
    stack = _anim(13, t=4, h=32, w=16)
    port, ref = _both("filter f (image in) in(xy + xy:[3 * sin(y / 5 + t * 6), 0]) "
                      "* (0.5 + frame / 8) end")
    ts = np.float32([0.05, 0.3, 0.55, 0.8])
    got = port.render_sharded(stack, num_frames=4, ts=ts, mesh=port_mesh(mesh_shape))
    want = ref.render_sharded(stack, num_frames=4, ts=ts, mesh=ref_mesh(mesh_shape))
    assert got.shape == (4, 32, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(mt.MMRuntimeError, match="num_frames"):
        port.render_sharded(stack, num_frames=3, mesh=port_mesh((2, 1, 1)))


@pytest.mark.parametrize("mesh_shape", ((1, 8, 1), (1, 2, 4)),
                         ids=lambda s: "x".join(map(str, s)))
def test_animated_render_tiled_matches_the_reference(mesh_shape):
    """An animated u8 stack through render_tiled(halo="auto"): the selected
    frame's block per tile, as the JAX package renders it."""
    stack = (np.random.RandomState(14).rand(3, 32, 16, 4) * 255).astype(np.uint8)
    port, ref = _both("filter f (image in) in(xy + xy:[2 * sin(y / 4), 2 * sin(x / 3)]) end")
    for fr in (1.0, 2.0):
        got = port.render_tiled(stack, frame=fr, t=0.3, mesh=port_mesh(mesh_shape))
        want = ref.render_tiled(stack, frame=fr, t=0.3, mesh=ref_mesh(mesh_shape))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("periodic", [True, False])
def test_render_frames_yields_render_animations_frames(periodic):
    """render_frames streams the frames render_animation returns, bit for
    bit, t = i/N (periodic) or i/(N-1); each against the oracle."""
    img = _anim(15)[0]
    port, ref = _both("filter f (image in) in(xy + xy:[2 * sin(y / 3 + t * 6), 0]) end")
    ropts = mm.RenderOptions(periodic=periodic)
    anim = port.render_animation(img, num_frames=4, options=_port_opts(ropts), device="cpu")
    frames = list(port.render_frames(img, num_frames=4, options=_port_opts(ropts),
                                     device="cpu"))
    assert torch.equal(torch.stack(frames), anim)
    ts = np.arange(4, dtype=np.float32) / (4 if periodic else 3)
    for i in range(4):
        want = ref.render(img, t=float(ts[i]), frame=float(i), options=ropts, interpret=True)
        np.testing.assert_allclose(anim[i].numpy(), want, rtol=RTOL, atol=ATOL)


def test_inputs_from_numpy_keeps_a_u8_stack_u8():
    stack = (np.random.RandomState(16).rand(2, 4, 5, 3) * 255).astype(np.uint8)
    (t,) = inputs_from_numpy([stack], "cpu")
    assert t.dtype == torch.uint8 and tuple(t.shape) == (2, 4, 5, 4)
    assert bool((t[..., 3] == 255).all()) and torch.equal(t[..., :3], torch.from_numpy(stack))
