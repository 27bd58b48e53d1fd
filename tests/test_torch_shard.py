"""The replicated-input sharded render (`Filter.render_sharded`,
parallel/shard.py) and the whole library through the input-sharded render,
on CPU meshes, plus the mesh and the refusals.

- render_sharded of pond, twirl and mandelbrot (and tests/test_sharding.py's
  sources the port renders) on (1,8,1) and (1,2,4) against the JAX
  package's render_sharded on its 8 virtual CPU devices and against the
  port's unsharded render, at rtol=1e-4, atol=1e-5;
- render_tiled(halo="auto") equals the port's unsharded render for every
  library entry the port renders whose displacement the static bound sizes
  (the sweep of tests/test_halo.py::test_library_filters_tiled_auto_halo_
  match_plain, over the whole library);
- a frame batch, a frame axis and animated inputs (once refused) against
  the JAX package's; `region` raises, naming its ROADMAP item; the default
  mesh needs a GPU.
"""

import os

import jax
import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mathmap_tpu_torch.kernels import sample_image as B1
from mathmap_tpu_torch.lang.parser import parse
from mathmap_tpu_torch.parallel.halo import auto_halo

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL, ATOL = 1e-4, 1e-5
MESHES = ((1, 8, 1), (1, 2, 4))


def _image(seed, h, w):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def port_mesh(shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


SHARDED = {
    # name -> (source or .mm path, number of image inputs, render kwargs)
    "pond": ("filters/Distorts/pond.mm", 1, dict(t=0.3)),
    "pond_params": ("filters/Distorts/pond.mm", 1, dict(params={"amplitude": 9.0})),
    "twirl": ("filters/Distorts/twirl.mm", 1, dict(t=0.3)),
    "mandelbrot": ("filters/Render/mandelbrot.mm", 0, {}),
    "mandelbrot_params": ("filters/Render/mandelbrot.mm", 0,
                          dict(params={"maxiter": 40, "zoom": 2.0, "cx": -0.7})),
    # a bare expression declares one image input, which these do not read
    "radial_waves": ("grayColor(0.5 + 0.5 * sin(r - a + t * 2 * pi))", 1, dict(t=0.25)),
    "polar_warp": ("origVal(toXY(ra:[r * 0.7, a + 0.4]))", 1, dict(t=0.25)),
    "julia_loop": ("z = ri:[x/X, y/Y]; c = ri:[-0.4, 0.6]; i = 0;"
                   "while z[0]*z[0] + z[1]*z[1] < 4 && i < 20 do z = z*z + c; i = i + 1 end;"
                   "grayColor(i / 20)", 1, {}),
}


def _compile(pkg, src):
    if src.endswith(".mm"):
        return pkg.compile_file(os.path.join(ROOT, src))
    return (mm.compile if pkg is mm else mt.compile_source)(src)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", sorted(SHARDED))
def test_render_sharded_matches_the_reference_and_the_unsharded_render(case, mesh_shape):
    src, n_inputs, kw = SHARDED[case]
    h, w = 48, 64
    inputs = [_image(5 + i, h, w) for i in range(n_inputs)]
    ref = _compile(mm, src)
    want = np.asarray(ref.render_sharded(*inputs, width=w, height=h,
                                         mesh=ref_make_mesh(*mesh_shape), **kw))
    port = _compile(mt, src)
    before = B1.sample_image.launches
    got = port.render_sharded(*inputs, width=w, height=h, mesh=port_mesh(mesh_shape), **kw)
    assert B1.sample_image.launches == before  # CPU tiles never launch
    assert got.shape == (h, w, 4) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    unsharded = port.render(*inputs, width=w, height=h, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), unsharded.numpy())


def test_render_sharded_uint8_input_and_output():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    u8 = (np.random.RandomState(3).rand(48, 64, 4) * 255).astype(np.uint8)
    opts = mt.RenderOptions(output_dtype="uint8")
    got = f.render_sharded(u8, mesh=port_mesh((1, 2, 4)), options=opts)
    assert got.dtype == torch.uint8
    assert torch.equal(got, f.render(u8, options=opts, device="cpu"))


def _library():
    """name -> (program, FilterDef), the first definition of each name in
    filters/ (the goldens' entries), every library filter in scope."""
    entries = {}
    root = os.path.join(ROOT, "filters")
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if fn.endswith(".mm"):
                with open(os.path.join(dirpath, fn)) as fh:
                    program = parse(fh.read())
                for fdef in program.filters:
                    entries.setdefault(fdef.name, (program, fdef))
    return entries


LIBRARY = _library()
SWEEP_SIZE = 128


def _library_filter(name):
    program, fdef = LIBRARY[name]
    f = mt.Filter(program, fdef)
    f.filters = {**{n: d for n, (_p, d) in LIBRARY.items()}, **f.filters}
    return f


def _sweep_entries():
    """The entries whose auto halo fits a 2-row mesh's 64-row tiles
    at 128x128, and the count of those the bound refuses."""
    fits, refused = [], 0
    for name in sorted(LIBRARY):
        f = _library_filter(name)
        try:
            halo = auto_halo(f.filters, f.fdef, SWEEP_SIZE, SWEEP_SIZE, mt.RenderOptions(),
                             ny=2, nx=1)
        except mt.MMRuntimeError:
            refused += 1
            continue
        if halo[0] <= SWEEP_SIZE // 2:
            fits.append(name)
    return fits, refused


SWEEP, SWEEP_REFUSED = _sweep_entries()


@pytest.mark.parametrize("name", SWEEP)
def test_library_entry_renders_tiled_like_unsharded(name):
    f = _library_filter(name)
    n_images = sum(1 for p in f.fdef.params if p.kind == "image")
    inputs = [_image(11 + i, SWEEP_SIZE, SWEEP_SIZE) for i in range(n_images)]
    size = dict(width=SWEEP_SIZE, height=SWEEP_SIZE, t=0.3)
    got = f.render_tiled(*inputs, halo="auto", mesh=port_mesh((1, 2, 1)), **size)
    want = f.render(*inputs, device="cpu", **size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_the_sweep_covers_most_of_the_library():
    assert len(SWEEP) >= 80 and len(SWEEP) + SWEEP_REFUSED <= len(LIBRARY)


@pytest.mark.parametrize("entry", ["render_sharded", "render_tiled"])
def test_a_frame_axis_is_not_ported(entry):
    """Once refused (ROADMAP A4): a one-frame render on a mesh with a frame
    axis of 2 renders over the first frame slice's tiles, as the JAX
    package's does on a (2,2,1) mesh of its virtual devices."""
    img = _image(1, 16, 8)
    kw = {"halo": 1} if entry == "render_tiled" else {}
    want = getattr(mm.compile("origVal(xy)"), entry)(
        img, mesh=ref_make_mesh(2, 2, 1, devices=jax.devices()[:4]), **kw)
    got = getattr(mt.compile_source("origVal(xy)"), entry)(img, mesh=port_mesh((2, 2, 1)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_a_frame_batch_is_not_ported():
    """Once refused (ROADMAP A4): a frame batch (num_frames > 1) renders,
    frame i at t = i/F, as the JAX package's does on its virtual devices."""
    src = "filter g () grayColor(t + frame / 4) end"
    want = mm.compile(src).render_sharded(
        width=8, height=8, num_frames=2, mesh=ref_make_mesh(2, 1, 1, devices=jax.devices()[:2]))
    got = mt.compile_source(src).render_sharded(
        width=8, height=8, num_frames=2, mesh=port_mesh((2, 1, 1)))
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entry", ["render_sharded", "render_tiled"])
def test_region_is_not_ported(entry):
    """Once refused (ROADMAP A4c): render_sharded refuses a region with
    the reference's ValueError, and render_tiled renders it in place on
    the full canvas, as the JAX package's does (tests/test_torch_region.py
    holds the rest)."""
    img = _image(1, 16, 8)
    kw = {"halo": 1} if entry == "render_tiled" else {}
    try:
        want = np.asarray(getattr(mm.compile("origVal(xy)"), entry)(
            img, mesh=ref_make_mesh(1, 2, 1, devices=jax.devices()[:2]),
            options=mm.RenderOptions(region=(0, 0, 4, 4)), **kw))
    except ValueError as e:
        want = e
    f = mt.compile_source("origVal(xy)")
    if isinstance(want, ValueError):
        with pytest.raises(ValueError, match="render_tiled"):
            getattr(f, entry)(img, mesh=port_mesh((1, 2, 1)),
                              options=mt.RenderOptions(region=(0, 0, 4, 4)), **kw)
        return
    got = getattr(f, entry)(img, mesh=port_mesh((1, 2, 1)),
                            options=mt.RenderOptions(region=(0, 0, 4, 4)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entry", ["render_sharded", "render_tiled"])
def test_animated_inputs_are_not_ported(entry):
    """Once refused (ROADMAP A4): an animated (T, H, W, 4) input renders
    its current frame on a mesh, as the JAX package's does."""
    stack = np.random.RandomState(2).rand(2, 16, 8, 4).astype(np.float32)
    kw = {"halo": 1} if entry == "render_tiled" else {}
    want = getattr(mm.compile("origVal(xy)"), entry)(
        stack, frame=1.0, mesh=ref_make_mesh(1, 2, 1, devices=jax.devices()[:2]), **kw)
    got = getattr(mt.compile_source("origVal(xy)"), entry)(
        stack, frame=1.0, mesh=port_mesh((1, 2, 1)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_the_default_mesh_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mt.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mt.compile_source("origVal(xy)").render_tiled(_image(1, 16, 8))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mt.make_mesh(1, 2, 1, devices=["cuda:0", "cuda:0"])


def test_make_mesh_shapes_and_repeated_devices():
    mesh = mt.make_mesh(1, None, 2, devices=["cpu"] * 6)
    assert mesh.shape == {"f": 1, "y": 3, "x": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        mt.make_mesh(1, 4, 1, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        mt.make_mesh(1, None, 2, devices=["cpu"] * 3)


@pytest.mark.parametrize("entry", ["render_sharded", "render_tiled"])
def test_a_size_the_mesh_does_not_divide_raises(entry):
    f = mt.compile_source("origVal(xy)")
    with pytest.raises(mt.MMRuntimeError, match="divisible"):
        getattr(f, entry)(_image(1, 15, 8), mesh=port_mesh((1, 2, 1)))
