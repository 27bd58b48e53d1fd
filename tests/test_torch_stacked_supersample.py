"""One walk of the body for a frame's s² grid subsamples
(`runtime/render.py::render_frame`, `stacked_grids`, `WALK_POINTS`) on
the CPU.

Under the grid supersampling scheme a frame evaluates its s² subsamples
stacked on the row axis, as many a walk as `WALK_POINTS` allows. Every
element sees the same operations on the same floats as in a walk of its
own, and the planes add in subsample order, so:

- the stacked frame equals the per-walk frame bit for bit (the per-walk
  frame: `WALK_POINTS` set to one subsample's points) for distortions, a
  loop, a filter that calls a user filter and a gaussian blur of a closure
  image, at s = 2 and 3, float32 and uint8 output, on a region, through
  `render_animation`, on the tiles of a CPU mesh (`render_sharded`,
  `render_tiled`) and through an exported artifact;
- a budget that groups the subsamples (s = 3 in walks of 4, 4 and 1)
  gives the same frame;
- a filter that draws rand(), itself or through a filter it calls, keeps
  one walk a subsample and holds to the JAX package's oracle;
- the corners scheme and s = 1 walk the body as they did: 2 and 1 walks,
  as many `mm.evaluate` spans.
"""

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
from mathmap_tpu_torch.runtime import render as R
from mathmap_tpu_torch.runtime.tracer import RenderContext
from mathmap_tpu_torch.utils import trace

W, H = 52, 36
RTOL, ATOL = 1e-4, 1e-5

CALLS_USER = """filter swirl (image in, float k: 0-4 (1.5))
  in(ra:[r, a + k * (1 - r / R)])
end
filter outer (image in)
  swirl(in, 2.5)(xy + xy:[3 * sin(y / 5), 0])
end"""
BLUR_CLOSURE = """filter shift (image in)
  in(xy + xy:[4 * sin(y / 6), 0])
end
filter blurred (image in)
  gaussian_blur(shift(in), 1.5)(xy * 0.9)
end"""
RAND = "filter n (image in) in(xy + xy:[rand(-2, 2), rand(-2, 2)]) end"
CALLS_RAND = """filter grain (image in)
  in(xy) + rgbaColor(rand(-0.1, 0.1), 0, 0, 0)
end
filter outer (image in)
  grain(in)(xy * 1.1)
end"""

FILES = {name: f"filters/Distorts/{name}.mm" for name in
         ("ripple", "wave", "fisheye", "twirl", "pond")}
FILES["mandelbrot"] = "filters/Render/mandelbrot.mm"
SOURCES = {"calls_user": CALLS_USER, "blur_closure": BLUR_CLOSURE}


def _filter(name):
    if name in SOURCES:
        return mt.compile_source(SOURCES[name])
    return mt.compile_file(FILES[name])


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(23)
    a = rng.random((H, W, 4)).astype(np.float32)
    a[..., 3] = 1.0
    return a


def _counted(fn):
    """fn() -> (its result, render.walks, mm.evaluate spans)."""
    before = trace.snapshot()
    out = fn()
    d = trace.since(before)
    return out, d["counters"].get("render.walks", 0), d["spans"].get(
        "mm.evaluate", {}).get("count", 0)


def _per_walk(monkeypatch, fn, points):
    """fn() with a budget of `points` a walk (one subsample's points: one
    walk a subsample), and its walks and spans."""
    with monkeypatch.context() as m:
        m.setattr(R, "WALK_POINTS", points)
        return _counted(fn)


def _equal(a, b):
    if a.dtype == torch.uint8:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("name", [*FILES, *SOURCES])
def test_the_stacked_frame_equals_the_per_walk_frame(monkeypatch, img, name, s, u8):
    f = _filter(name)
    opts = mt.RenderOptions(supersample=s, output_dtype="uint8" if u8 else "float32")
    inputs = () if name == "mandelbrot" else (img,)

    def run():
        return f.render(*inputs, width=W, height=H, t=0.3, options=opts, device="cpu")

    got, walks, spans = _counted(run)
    want, want_walks, want_spans = _per_walk(monkeypatch, run, H * W)
    assert (walks, spans) == (1, 1)
    assert (want_walks, want_spans) == (s * s, s * s)
    assert got.dtype == (torch.uint8 if u8 else torch.float32)
    assert _equal(got, want)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("name", ["twirl", "mandelbrot"])
def test_a_stacked_region_equals_the_per_walk_region_and_the_full_frames_crop(
        monkeypatch, img, name, s):
    f = _filter(name)
    inputs = () if name == "mandelbrot" else (img,)
    reg = (7, 5, 31, 19)

    def run(region=reg):
        return f.render(*inputs, width=W, height=H, device="cpu",
                        options=mt.RenderOptions(supersample=s, region=region))

    got, walks, _ = _counted(run)
    want, want_walks, _ = _per_walk(monkeypatch, run, reg[2] * reg[3])
    assert (walks, want_walks) == (1, s * s)
    assert _equal(got, want)
    full = run(None)
    assert _equal(got, full[reg[1]:reg[1] + reg[3], reg[0]:reg[0] + reg[2]])


@pytest.mark.parametrize("name", ["ripple", "wave"])
def test_a_stacked_sweep_equals_the_per_walk_sweep(monkeypatch, img, name):
    f = _filter(name)
    frames = 3

    def run():
        return f.render_animation(img, num_frames=frames, device="cpu",
                                  options=mt.RenderOptions(supersample=2))

    got, walks, spans = _counted(run)
    want, want_walks, _ = _per_walk(monkeypatch, run, H * W)
    assert (walks, spans, want_walks) == (frames, frames, 4 * frames)
    assert _equal(got, want)


@pytest.mark.parametrize("how", ["sharded", "tiled"])
@pytest.mark.parametrize("name", ["pond", "ripple"])
def test_stacked_tiles_of_a_cpu_mesh_equal_the_per_walk_tiles(monkeypatch, name, how):
    f = _filter(name)
    mesh = mt.make_mesh(1, 2, 2, devices=["cpu"] * 4)
    img = np.random.default_rng(29).random((96, 128, 4)).astype(np.float32)
    opts = mt.RenderOptions(supersample=2)

    def run():
        if how == "sharded":
            return f.render_sharded(img, mesh=mesh, t=0.4, options=opts)
        return f.render_tiled(img, mesh=mesh, t=0.4, options=opts)

    got, walks, _ = _counted(run)
    want, want_walks, _ = _per_walk(monkeypatch, run, 48 * 64)
    assert (walks, want_walks) == (4, 16)
    assert _equal(got, want)
    lone = f.render(img, t=0.4, options=opts, device="cpu")
    assert _equal(got, lone)


def test_an_exported_stacked_frame_equals_the_per_walk_artifact(monkeypatch, img, tmp_path):
    f = _filter("twirl")
    opts = mt.RenderOptions(supersample=2)
    export_artifact(f, str(tmp_path / "stacked.mmxa"), W, H, options=opts,
                    params={"angle": 2.0}, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(R, "WALK_POINTS", H * W)
        export_artifact(f, str(tmp_path / "per_walk.mmxa"), W, H, options=opts,
                        params={"angle": 2.0}, device="cpu")
    got = load_artifact(str(tmp_path / "stacked.mmxa")).render(img, params={"angle": 3.0})
    want = load_artifact(str(tmp_path / "per_walk.mmxa")).render(img, params={"angle": 3.0})
    assert _equal(got, want)
    live = f.render(img, params={"angle": 3.0}, options=opts, device="cpu")
    assert _equal(got, live)


@pytest.mark.parametrize("name", ["ripple", "mandelbrot"])
def test_a_budget_that_groups_the_subsamples_gives_the_one_walk_frame(monkeypatch, img, name):
    """s = 3 with room for four subsamples a walk: walks of 4, 4 and 1,
    added in subsample order."""
    f = _filter(name)
    inputs = () if name == "mandelbrot" else (img,)

    def run():
        return f.render(*inputs, width=W, height=H, t=0.7, device="cpu",
                        options=mt.RenderOptions(supersample=3))

    one, walks, _ = _counted(run)
    grouped, grouped_walks, grouped_spans = _per_walk(monkeypatch, run, 4 * H * W + 3)
    per_walk, _, _ = _per_walk(monkeypatch, run, H * W)
    assert (walks, grouped_walks, grouped_spans) == (1, 3, 3)
    assert _equal(grouped, one)
    assert _equal(grouped, per_walk)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("src", [RAND, CALLS_RAND], ids=["direct", "called"])
def test_a_rand_filter_keeps_a_walk_a_subsample(img, src, s):
    ro = mm.RenderOptions(supersample=s, seed=5)
    got, walks, spans = _counted(lambda: mt.compile_source(src).render(
        img, options=options_from_reference(ro), device="cpu"))
    assert (walks, spans) == (s * s, s * s)
    want = np.asarray(mm.compile_source(src).render(img, options=ro, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fields,walks", [
    (dict(supersample=2, supersample_scheme="corners"), 2),
    (dict(supersample=3, supersample_scheme="corners"), 2),
    (dict(supersample=1), 1),
], ids=["corners2", "corners3", "off"])
def test_corners_and_one_sample_walk_as_before(monkeypatch, img, fields, walks):
    f = _filter("ripple")

    def run():
        return f.render(img, options=mt.RenderOptions(**fields), device="cpu")

    got, n, spans = _counted(run)
    assert (n, spans) == (walks, walks)
    with monkeypatch.context() as m:
        m.setattr(R, "WALK_POINTS", 1)
        again, n1, spans1 = _counted(run)
    assert (n1, spans1) == (walks, walks)
    assert _equal(got, again)


def test_subsamples_per_walk_follows_the_budget_rand_and_the_spec():
    def per_walk(width, height, s, f=_filter("ripple"), dtype=torch.float32):
        ctx = RenderContext(device=torch.device("cpu"), width=width, height=height,
                            opts=mt.RenderOptions(supersample=s), dtype=dtype,
                            filters=f.filters)
        return R.subsamples_per_walk(ctx, f.fdef, s)

    assert per_walk(1920, 1080, 2) == 4
    assert per_walk(3840, 2160, 2) == 4
    assert per_walk(3840, 2160, 3) == 4
    assert per_walk(7680, 4320, 2) == 1
    assert per_walk(1920, 1080, 1) == 1
    assert per_walk(1920, 1080, 2, dtype=torch.float64) == 1
    assert per_walk(64, 64, 2, f=mt.compile_source(RAND)) == 1
    assert per_walk(64, 64, 2, f=mt.compile_source(CALLS_RAND)) == 1
    assert per_walk(64, 64, 2, f=mt.compile_source(CALLS_USER)) == 4
