"""Region (selection) renders and the corner-grid supersampling scheme of
the port (`RenderOptions.region`, `supersample_scheme="corners"`) on the
CPU, against the JAX package's NumPy oracle (`interpret=True`) at
rtol=1e-4, atol=1e-5, and against the port's own full render: a region
render must be the full render's crop BIT FOR BIT on every single-device
path (tests/test_region.py's spec).

The cases mirror tests/test_region.py (all but the artifact round trip,
which waits for ROADMAP A10) and the region cases of tests/test_halo.py:
on the tiled path the output is the full canvas, the selection rendered in
place (held against the oracle's region render), every other pixel input
0's current frame bit for bit, on (1,4,1), (2,2,1) and (1,2,2) CPU meshes.
Then corners against the oracle for a pointwise filter, a warp, rand() and
a loop, with and without a region, and render_sharded's refusal.
"""

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.kernels.finish_rgba import pack_uint8

RTOL, ATOL = 1e-4, 1e-5
REG = (33, 7, 130, 41)  # deliberately unaligned origin and size

WARP = ("filter warp (image in) "
        "in(xy + xy:[0.1*sin(y*3), 0.1*cos(x*3)]) end")
POINTWISE = "filter g () rgbaColor(x/W+0.5, y/H+0.5, t, 1) end"
RAND = "filter n () grayColor(rand(0,1)) end"
MAND = """filter mand ()
  cx = x/W*3 - 0.5; cy = y/H*3;
  zx = 0.0; zy = 0.0; i = 0;
  while zx*zx + zy*zy < 4 && i < 30 do
    nx = zx*zx - zy*zy + cx; zy = 2*zx*zy + cy; zx = nx;
    i = i + 1
  end;
  grayColor(i / 30)
end"""
RAND_LOOP = ("filter rw () s = 0; i = 0; while s < 1 && i < 40 do "
             "s = s + rand(0, 0.2); i = i + 1 end; grayColor(i / 40) end")


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(7)
    a = rng.random((64, 256, 4)).astype(np.float32)
    a[..., 3] = 1.0
    return a


def crop(full, reg=REG):
    x, y, w, h = reg
    return full[y:y + h, x:x + w]


def both(src, *inputs, **opt_fields):
    """(the oracle's render, the port's CPU render) of `src` under the same
    options, both numpy; `t` and the canvas size pass through."""
    kw = {k: opt_fields.pop(k) for k in ("t", "width", "height", "frame") if k in opt_fields}
    ro = mm.RenderOptions(**opt_fields)
    want = np.asarray(mm.compile_source(src).render(*inputs, options=ro, interpret=True, **kw))
    got = mt.compile_source(src).render(*inputs, options=options_from_reference(ro),
                                        device="cpu", **kw).numpy()
    return want, got


def check_region(src, *inputs, reg=REG, **fields):
    """The port's region render against the oracle's, and against the crop
    of the port's own full render, bit for bit."""
    want, got = both(src, *inputs, region=reg, **fields)
    assert got.shape == (reg[3], reg[2], 4)
    if want.dtype == np.uint8:
        assert got.dtype == np.uint8
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    kw = {k: fields.pop(k) for k in ("t", "width", "height") if k in fields}
    full = mt.compile_source(src).render(*inputs, device="cpu", options=mt.RenderOptions(
        **fields), **kw).numpy()
    assert np.array_equal(crop(full, reg), got)
    return got


# -- tests/test_region.py, case for case ----------------------------------

def test_region_pointwise_bitwise():
    got = check_region(POINTWISE, width=256, height=64, t=0.25)
    assert got.shape == (41, 130, 4)


def test_region_oracle_bitwise(img):
    check_region(WARP, img)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_region_pallas_sampler_bitwise(img, precision):
    """The TPU sampler options are accepted and change nothing here."""
    check_region(WARP, img, sampler="pallas", pallas_precision=precision)


def test_region_rand_keeps_global_pixel_identity():
    check_region(RAND, width=256, height=64)


def test_region_while_loop_bitwise():
    check_region(MAND, width=256, height=64)


def test_region_supersample_corners_bitwise():
    check_region(POINTWISE, width=256, height=64, supersample=2,
                 supersample_scheme="corners")


def test_region_animation_sweep(img):
    f = mt.compile_source(WARP)
    o = mt.RenderOptions(region=REG)
    frames = f.render_animation(img, num_frames=3, options=o, device="cpu")
    assert frames.shape == (3, 41, 130, 4)
    assert torch.equal(frames[0], f.render(img, t=0.0, options=o, device="cpu"))
    want = np.asarray(mm.compile_source(WARP).render(
        img, t=1 / 3, frame=1.0, options=mm.RenderOptions(region=REG), interpret=True))
    np.testing.assert_allclose(frames[1].numpy(), want, rtol=RTOL, atol=ATOL)
    streamed = list(f.render_frames(img, num_frames=3, options=o, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(streamed, frames))


def test_region_u8_output(img):
    got = check_region(WARP, img, output_dtype="uint8")
    assert got.dtype == np.uint8


def test_region_validation():
    with pytest.raises(ValueError):
        mt.RenderOptions(region=(0, 0, 0, 4))
    with pytest.raises(ValueError):
        mt.RenderOptions(region=(-1, 0, 4, 4))
    with pytest.raises(ValueError):
        mt.RenderOptions(region=(1, 2, 3))
    assert mt.RenderOptions(region=[1, 2, 3, 4]).region == (1, 2, 3, 4)
    f = mt.compile_source(POINTWISE)
    with pytest.raises(ValueError, match="exceeds the 32x32 canvas"):
        f.render(width=32, height=32, device="cpu",
                 options=mt.RenderOptions(region=(30, 0, 10, 4)))


def test_region_rejected_by_sharded_accepted_by_tiled(img):
    """render_sharded rejects region with the reference's guidance; the
    tiled path renders it in place on the full canvas."""
    f = mt.compile_source(WARP)
    mesh = mt.make_mesh(1, 4, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="render_tiled"):
        f.render_sharded(img, mesh=mesh, options=mt.RenderOptions(region=REG))
    with pytest.raises(ValueError, match="render_tiled"):
        f.render_sharded(img, mesh=mesh, num_frames=2, options=mt.RenderOptions(region=REG))
    out = f.render_tiled(img, options=mt.RenderOptions(region=REG), halo=8,
                         mesh=mesh).numpy()
    assert out.shape == img.shape
    mask = np.zeros(img.shape[:2] + (1,), bool)
    x, y, w, h = REG
    mask[y:y + h, x:x + w] = True
    np.testing.assert_array_equal(np.where(mask, img, out), img)


def test_region_batch_jobs_match_lone_region_renders(img):
    src = "filter wp (image in, float k: 0-1 (0.1)) in(xy + xy:[k*sin(y*3), k*cos(x*3)]) end"
    f = mt.compile_source(src)
    o = mt.RenderOptions(region=REG)
    ks = (0.1, 0.3, 0.5)
    outs = f.render_batch(mt.shared(img), params=[{"k": k} for k in ks],
                          frames=[0, 0, 0], options=o, device="cpu")
    assert outs.shape == (3, 41, 130, 4)
    ref = mm.compile_source(src)
    for j, k in enumerate(ks):
        lone = f.render(img, params={"k": k}, options=o, device="cpu")
        assert torch.equal(outs[j], lone)
        want = np.asarray(ref.render(img, params={"k": k}, interpret=True,
                                     options=mm.RenderOptions(region=REG)))
        np.testing.assert_allclose(outs[j].numpy(), want, rtol=RTOL, atol=ATOL)


# -- the tiled path: the selection rendered in place ------------------------

H, W = 32, 16
TILED_MESHES = ((1, 4, 1), (2, 2, 1), (1, 2, 2))
TILED_SRC = "origVal(xy + xy:[2 * sin(y / 5), 2 * sin(x / 3)])"


def _image(seed, h=H, w=W):
    a = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    a[..., 3] = 1.0
    return a


def _mesh(shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _mask(reg, h=H, w=W):
    m = np.zeros((h, w, 1), bool)
    x, y, rw, rh = reg
    m[y:y + rh, x:x + rw] = True
    return m


def _tiled(src, inp, reg, mesh_shape, halo=4, **fields):
    kw = {k: fields.pop(k) for k in ("t", "frame") if k in fields}
    return mt.compile_source(src).render_tiled(
        inp, halo=halo, mesh=_mesh(mesh_shape), options=mt.RenderOptions(region=reg, **fields),
        **kw).numpy()


@pytest.mark.parametrize("mesh_shape", TILED_MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("reg", [
    (3, 5, 9, 11),    # interior, spans several row tiles
    (0, 0, 16, 8),    # one (1,4,1) tile's rows exactly
    (2, 29, 5, 3),    # bottom edge, partial overlap on the last tile
    (0, 0, 16, 32),   # the whole canvas
    (9, 1, 4, 3),     # inside one tile (other tiles evaluate nothing)
])
def test_tiled_region_selection_matches_the_oracle_and_passes_input_0(reg, mesh_shape):
    img = _image(17)
    got = _tiled(TILED_SRC, img, reg, mesh_shape)
    assert got.shape == img.shape and got.dtype == np.float32
    want = np.asarray(mm.compile_source(TILED_SRC).render(
        img, interpret=True, options=mm.RenderOptions(region=reg)))
    np.testing.assert_allclose(crop(got, reg), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.where(_mask(reg), img, got), img)
    # and the selection is the full tiled render's crop
    full = mt.compile_source(TILED_SRC).render_tiled(img, halo=4, mesh=_mesh(mesh_shape))
    np.testing.assert_array_equal(crop(got, reg), crop(full.numpy(), reg))


@pytest.mark.parametrize("mesh_shape", TILED_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_region_matches_the_reference_render_tiled(mesh_shape):
    """The JAX package's in-place tiled region on its virtual devices."""
    import jax

    from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh

    img = _image(18)
    reg = (1, 6, 13, 17)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3 + t)])"
    n = int(np.prod(mesh_shape))
    want = np.asarray(mm.compile_source(src).render_tiled(
        img, halo=4, t=0.37, mesh=ref_make_mesh(*mesh_shape, devices=jax.devices()[:n]),
        options=mm.RenderOptions(region=reg)))
    got = _tiled(src, img, reg, mesh_shape, t=0.37)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh_shape", TILED_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_region_u8_io_passes_the_input_bytes(mesh_shape):
    rng = np.random.RandomState(23)
    u8 = (rng.rand(H, W, 4) * 255).astype(np.uint8)
    reg = (4, 9, 7, 10)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3)])"
    got = _tiled(src, u8, reg, mesh_shape, output_dtype="uint8")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(np.where(_mask(reg), u8, got), u8)
    want = np.asarray(mm.compile_source(src).render(
        u8, interpret=True, options=mm.RenderOptions(region=reg, output_dtype="uint8")))
    assert int(np.abs(crop(got, reg).astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
def test_tiled_region_converts_the_pass_through_to_the_output_dtype(out_dtype):
    """f32 in, u8 out: the background is packed; u8 in, f32 out: it is
    converted by u8/255 (the render's own rules)."""
    rng = np.random.RandomState(24)
    u8 = (rng.rand(H, W, 4) * 255).astype(np.uint8)
    f32 = _image(25)
    reg = (4, 9, 7, 10)
    src = "origVal(xy)"
    if out_dtype == "uint8":
        got = _tiled(src, f32, reg, (1, 4, 1), output_dtype="uint8")
        bg = pack_uint8(torch.from_numpy(f32)).numpy()
    else:
        got = _tiled(src, u8, reg, (1, 4, 1))
        bg = u8.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(np.where(_mask(reg), bg, got), bg)


@pytest.mark.parametrize("mesh_shape", TILED_MESHES[:2], ids=lambda s: "x".join(map(str, s)))
def test_tiled_region_animated_background_is_the_current_frame(mesh_shape):
    stack = np.random.RandomState(29).rand(3, H, W, 4).astype(np.float32)
    reg = (2, 4, 6, 8)
    src = "origVal(xy + xy:[0, 1])"
    for frame in (0.0, 2.0, 1.4):
        got = _tiled(src, stack, reg, mesh_shape, halo=3, frame=frame)
        cur = stack[int(np.floor(frame + 0.5))]
        np.testing.assert_array_equal(np.where(_mask(reg), cur, got), cur)
        want = np.asarray(mm.compile_source(src).render(
            stack, frame=frame, interpret=True, options=mm.RenderOptions(region=reg)))
        np.testing.assert_allclose(crop(got, reg), want, rtol=RTOL, atol=ATOL)


def test_tiled_region_out_of_bounds_raises():
    with pytest.raises(ValueError, match="exceeds"):
        _tiled("origVal(xy)", _image(31), (10, 0, 10, 4), (1, 4, 1), halo=1)


def test_tiled_region_supersample_grid():
    img = _image(37)
    reg = (3, 5, 9, 11)
    src = "origVal(xy + xy:[0, 2 * sin(x / 3)])"
    got = _tiled(src, img, reg, (1, 4, 1), supersample=2)
    want = np.asarray(mm.compile_source(src).render(
        img, interpret=True, options=mm.RenderOptions(region=reg, supersample=2)))
    np.testing.assert_allclose(crop(got, reg), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.where(_mask(reg), img, got), img)


def test_tiled_region_without_an_input_raises():
    f = mt.compile_source(POINTWISE)
    with pytest.raises(mt.MMRuntimeError, match="at least one input"):
        f.render_tiled(width=W, height=H, halo=1, mesh=_mesh((1, 4, 1)),
                       options=mt.RenderOptions(region=(0, 0, 4, 4)))


def test_tiled_refuses_corners_as_the_reference_does():
    o = dict(supersample=2, supersample_scheme="corners")
    f = mt.compile_source("origVal(xy)")
    with pytest.raises(ValueError, match="corners"):
        f.render_tiled(_image(3), halo=2, mesh=_mesh((1, 4, 1)), options=mt.RenderOptions(**o))
    with pytest.raises(ValueError, match="corners"):
        mm.compile_source("origVal(xy)").render_tiled(
            _image(3), halo=2, options=mm.RenderOptions(**o))


# -- corners ------------------------------------------------------------

CORNER_CASES = {
    "pointwise": (POINTWISE, False, dict(t=0.25, width=64, height=48)),
    "warp": (WARP, True, {}),
    "rand": (RAND, False, dict(width=64, height=48)),
    "rand_loop": (RAND_LOOP, False, dict(width=64, height=48, seed=3)),
    "loop": (MAND, False, dict(width=64, height=48)),
    "gradient": ("filter g (gradient gr) gr(clamp(r / R, 0, 1)) end", False,
                 dict(width=64, height=48)),
}


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("region", [None, (5, 3, 40, 30)], ids=["full", "region"])
@pytest.mark.parametrize("case", sorted(CORNER_CASES))
def test_corners_match_the_oracle(case, region, s, img):
    src, takes_image, fields = CORNER_CASES[case]
    inputs = [img[:48, :64]] if takes_image else []
    want, got = both(src, *inputs, supersample=s, supersample_scheme="corners",
                     region=region, **fields)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_corners_draw_a_fresh_rand_stream_for_the_centres():
    """The counter carries from the corner grid into the centres: a
    rand() filter under corners is not the average of one stream drawn
    twice, and matches the oracle bit for bit."""
    want, got = both(RAND, width=32, height=24, supersample=2, supersample_scheme="corners")
    np.testing.assert_array_equal(got, want)
    f = mt.compile_source(RAND)
    ctx_first = f.render(width=32, height=24, device="cpu").numpy()
    # the centre samples are the render's second draw, not its first
    assert not np.allclose(got, ctx_first)


def test_corners_with_supersample_1_is_a_plain_render():
    f = mt.compile_source(POINTWISE)
    a = f.render(width=32, height=24, device="cpu",
                 options=mt.RenderOptions(supersample_scheme="corners"))
    assert torch.equal(a, f.render(width=32, height=24, device="cpu"))


def test_corners_u8_output_and_batch(img):
    f = mt.compile_source(WARP)
    o = mt.RenderOptions(supersample=2, supersample_scheme="corners", output_dtype="uint8",
                         region=(10, 4, 30, 20))
    outs = f.render_batch(np.stack([img, img[::-1]]), frames=[0, 0], options=o, device="cpu")
    assert outs.shape == (2, 20, 30, 4) and outs.dtype == torch.uint8
    assert torch.equal(outs[1], f.render(img[::-1], options=o, device="cpu"))
    want = np.asarray(mm.compile_source(WARP).render(
        img, interpret=True, options=mm.RenderOptions(
            supersample=2, supersample_scheme="corners", output_dtype="uint8",
            region=(10, 4, 30, 20))))
    assert int(np.abs(outs[0].numpy().astype(int) - want.astype(int)).max()) <= 1


def test_options_from_reference_carries_region_and_corners():
    ro = mm.RenderOptions(region=(1, 2, 3, 4), supersample=2, supersample_scheme="corners")
    po = options_from_reference(ro)
    assert po.region == (1, 2, 3, 4) and po.supersample_scheme == "corners"
