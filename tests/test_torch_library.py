"""The port's expression database, composer and gaussian blur on the CPU,
mirroring tests/test_library.py (the database, s-expressions, the
composer, the blur, the 22-composition gallery, user directories) and
tests/test_native.py's blur cases. Renders are held to the NumPy oracle
(`interpret=True`) of the JAX package's own database or source at
rtol=1e-4, atol=1e-5, and to the closed forms of the reference's tests.
The reference's GIF-writing test waits for the port's imgio (ROADMAP A8).
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.expression_db import default_db as ref_default_db
from mathmap_tpu_torch.designer import sexpr
from mathmap_tpu_torch.designer.graph import DesignerGraph, InputRef, from_mmc, from_pipeline
from mathmap_tpu_torch.expression_db import ExpressionDB, default_db
from mathmap_tpu_torch.utils.errors import MMNameError, MMRuntimeError

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W = 12, 16
RTOL, ATOL = 1e-4, 1e-5
NEAREST = dict(interpolation="nearest")


def _image(seed=3):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _render(f, *inputs, options=None, **kw):
    return f.render(*inputs, device="cpu", options=mt.RenderOptions(**(options or {})),
                    **kw).numpy()


def _oracle(f, *inputs, options=None, **kw):
    return f.render(*inputs, interpret=True, options=mm.RenderOptions(**(options or {})), **kw)


def _gray(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


# ---------------------------------------------------------------------------
# expression database
# ---------------------------------------------------------------------------

def test_db_scans_categories():
    db = default_db()
    assert not db.errors
    assert {"Colors", "Distorts", "Combine", "Render", "Map", "Noise"} <= set(db.categories)
    assert db.entries["fisheye"].category == "Distorts"
    assert db.entries["fisheye"].doc


def test_db_matches_the_reference_database():
    """Names, categories, docs and the composers' generated sources equal
    the JAX package's database entry for entry."""
    db, ref = default_db(), ref_default_db()
    assert db.names() == ref.names() and len(db.entries) == 177
    assert db.categories == ref.categories
    for name, e in db.entries.items():
        r = ref.entries[name]
        assert (e.category, e.path, e.source, e.doc) == (r.category, r.path, r.source, r.doc)
    assert db.tree() == ref.tree()


def test_db_compile_renders():
    img = _image()
    out = _render(default_db().compile("invert"), img)
    np.testing.assert_allclose(out[..., 0], 1 - img[..., 0], atol=1e-6)


def test_db_cross_file_filter_call():
    """A filter calls library filters that live in other files."""
    db = default_db()
    chain = mt.compile_source("filter chain (image in) invert(grayscale(in))(xy) end")
    chain.filters.update(db.library_defs())
    img = _image()
    out = _render(chain, img, options=NEAREST)
    np.testing.assert_allclose(out[..., 0], 1 - _gray(img), atol=1e-5)


def test_db_unknown_name():
    with pytest.raises(MMNameError):
        default_db().compile("nope")


def test_db_tree_listing():
    tree = default_db().tree()
    assert "Distorts/" in tree and "fisheye" in tree


def test_db_compile_puts_the_whole_library_in_scope():
    db = default_db()
    f = db.compile("old_photo")
    assert set(db.entries) <= set(f.filters) and f.fdef is db.entries["old_photo"].fdef


# ---------------------------------------------------------------------------
# s-expressions
# ---------------------------------------------------------------------------

def test_sexpr_roundtrip():
    forms = sexpr.loads('(composer (node "a" "fisheye" (param "strength" 2)) (output "a"))')
    assert sexpr.loads(sexpr.dumps(forms[0]))[0] == forms[0]


def test_sexpr_comments_and_strings():
    forms = sexpr.loads('; comment\n(a "he\\"llo" 1.5)')
    assert forms[0][1] == 'he"llo' and forms[0][2] == 1.5


@pytest.mark.parametrize("text", ["(a (b", "(a))", '(a "b', ""])
def test_sexpr_errors_match_the_reference(text):
    from mathmap_tpu.designer import sexpr as ref_sexpr

    try:
        want = ref_sexpr.loads(text)
    except mm.MMSyntaxError as exc:
        with pytest.raises(mt.MMSyntaxError, match=re.escape(str(exc))):
            sexpr.loads(text)
    else:
        assert sexpr.loads(text) == want


# ---------------------------------------------------------------------------
# composer / designer
# ---------------------------------------------------------------------------

def test_composer_chain_matches_manual():
    g = DesignerGraph(db=default_db())
    a = g.add("grayscale", **{"in": InputRef(0)})
    b = g.add("invert")
    g.connect(a, b, "in")
    assert "filter composed" in g.to_source()
    img = _image()
    out = _render(g.compile(), img, options=NEAREST)
    np.testing.assert_allclose(out[..., 0], 1 - _gray(img), atol=1e-5)


def test_composer_params_and_mmc_roundtrip(tmp_path):
    db = default_db()
    g = DesignerGraph(db=db)
    n1 = g.add("twirl", **{"in": InputRef(0), "angle": 4.0})
    path = os.path.join(tmp_path, "t.mmc")
    g.save(path)
    with open(path) as fh:
        g2 = from_mmc(fh.read(), db=db)
    assert g2.output == n1 and g2.nodes[n1].params["angle"] == 4.0
    img = _image()
    out1, out2 = _render(g.compile(), img), _render(g2.compile(), img)
    np.testing.assert_array_equal(out1, out2)
    direct = _render(db.compile("twirl"), img, params={"angle": 4.0})
    np.testing.assert_allclose(out1, direct, atol=1e-6)


def test_composer_cycle_detection():
    g = DesignerGraph(db=default_db())
    a, b = g.add("invert"), g.add("invert")
    g.connect(a, b, "in")
    g.connect(b, a, "in")
    with pytest.raises(MMRuntimeError):
        g.to_source()


def test_composer_middle_default_spelled_out():
    g = DesignerGraph(db=default_db())
    # lens has (in, size, zoom, cx, cy); setting only cx spells out the
    # defaults of size and zoom
    g.add("lens", **{"in": InputRef(0), "cx": 1.0})
    src = g.to_source()
    assert "200.0" in src and "2.0" in src


def test_composer_source_equals_the_reference():
    from mathmap_tpu.designer.graph import DesignerGraph as RefGraph
    from mathmap_tpu.designer.graph import InputRef as RefInputRef

    g, r = DesignerGraph(db=default_db()), RefGraph(db=ref_default_db())
    for graph, ref in ((g, InputRef), (r, RefInputRef)):
        a = graph.add("pond", **{"in": ref(0), "amplitude": 5.0})
        graph.add("vignette", **{"in": a})
    assert g.to_source() == r.to_source() and g.to_mmc() == r.to_mmc()


def test_pipeline_chain_from_a_spec():
    db = default_db()
    img = _image()
    out = _render(from_pipeline("grayscale | twirl angle=4.5", db).compile(), img)
    gray = _render(mt.compile_file(os.path.join(ROOT, "filters", "Colors", "grayscale.mm")),
                   img, options=NEAREST)
    direct = _render(db.compile("twirl"), gray, params={"angle": 4.5})
    np.testing.assert_allclose(out, direct, atol=2e-2)  # resampled chain vs composed
    with pytest.raises(MMNameError):
        from_pipeline("does_not_exist | twirl", db)


def test_composer_unknown_param_names_the_node():
    g = DesignerGraph(db=default_db())
    g.add("twirl", **{"in": InputRef(0), "angel": 4.0})
    with pytest.raises(MMNameError, match="angel"):
        g.to_source()


# ---------------------------------------------------------------------------
# gaussian blur (runtime/native_filters.py)
# ---------------------------------------------------------------------------

BLUR = "filter f (image in) gaussian_blur(in, {})(xy) end"


def test_gaussian_blur_constant_image_invariant():
    img = np.full((H, W, 4), 0.6, np.float32)
    out = _render(mt.compile_source(BLUR.format(2)), img, options=NEAREST)
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_gaussian_blur_smooths():
    img = np.zeros((H, W, 4), np.float32)
    img[H // 2, W // 2] = 1.0
    out = _render(mt.compile_source(BLUR.format(1.5)), img, options=NEAREST)
    c, n = out[H // 2, W // 2, 0], out[H // 2, W // 2 + 1, 0]
    assert 0 < c < 1 and 0 < n < c  # spread out, monotone falloff


@pytest.mark.parametrize("sigma", [0.0, 0.4, 1.5, 2, 3.7, 9])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_gaussian_blur_parity(sigma, interp):
    """The oracle's blur bit for bit at the pixel centres, then sampled."""
    img = _image()
    src = BLUR.format(sigma)
    out = _render(mt.compile_source(src), img, options=dict(interpolation=interp))
    want = _oracle(mm.compile(src), img, options=dict(interpolation=interp))
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    if interp == "nearest":
        np.testing.assert_array_equal(out, want)


def test_gaussian_blur_uint8_input():
    img = np.floor(_image(4) * 255 + 0.5).astype(np.uint8)
    src = BLUR.format(1.5)
    np.testing.assert_array_equal(_render(mt.compile_source(src), img, options=NEAREST),
                                  _oracle(mm.compile(src), img, options=NEAREST))


def test_gaussian_blur_traced_stddev_raises_with_guidance():
    """A passed, non-static stddev raises, as on the reference's jit path;
    a static_params name and the default both render like the oracle."""
    src = "filter f (image in, float s: 0-10 (2)) gaussian_blur(in, s)(xy) end"
    f, ref = mt.compile_source(src), mm.compile(src)
    img = np.random.RandomState(0).rand(16, 24, 4).astype(np.float32)
    with pytest.raises(MMRuntimeError, match="static"):
        f.render(img, params={"s": 5.0}, device="cpu")
    o = ref.render(img, interpret=True, params={"s": 5.0})
    j = f.render(img, params={"s": 5.0}, options=mt.RenderOptions(static_params=("s",)),
                 device="cpu")
    np.testing.assert_allclose(j.numpy(), o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f.render(img, device="cpu").numpy(),
                               ref.render(img, interpret=True), rtol=RTOL, atol=ATOL)


def test_gaussian_blur_folded_stddev():
    """A stddev that folds from literals is known before the render."""
    src = "filter f (image in) gaussian_blur(in, sqrt(2) * 1.5 + 0.25)(xy) end"
    img = _image(6)
    np.testing.assert_allclose(_render(mt.compile_source(src), img),
                               _oracle(mm.compile(src), img), rtol=RTOL, atol=ATOL)


def test_gaussian_blur_animated_input():
    img = np.random.RandomState(1).rand(16, 24, 4).astype(np.float32)
    anim = np.stack([img, img[::-1]])
    src = BLUR.format(1.5)
    got = mt.compile_source(src).render(anim, width=24, height=16, frame=1.0, device="cpu")
    want = mm.compile(src).render(anim, width=24, height=16, frame=1.0, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gaussian_blur_of_a_closure_image():
    """A filter value is rasterised over the output grid, then blurred."""
    src = ("filter ring (float w: 0-9 (3)) grayColor(abs(r - 4) < w) end "
           "filter f (image in) gaussian_blur(ring(2), 1.2)(xy) * in(xy) end")
    img = _image(7)
    np.testing.assert_allclose(_render(mt.compile_source(src), img),
                               _oracle(mm.compile(src), img), rtol=RTOL, atol=ATOL)


def test_gaussian_blur_tiled_rejected():
    f = mt.compile_source(BLUR.format(1.5))
    img = np.random.RandomState(2).rand(32, 16, 4).astype(np.float32)
    with pytest.raises(MMRuntimeError, match="tiled"):
        f.render_tiled(img, halo=4, mesh=mt.make_mesh(1, 2, 1, devices=["cpu"] * 2))


def test_gaussian_blur_sharded_matches_the_reference():
    """On a grid-split mesh every tile blurs the whole input, as the
    reference's sharded render does."""
    import jax

    from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh

    img = np.random.RandomState(8).rand(32, 16, 4).astype(np.float32)
    src = BLUR.format(2.5)
    want = mm.compile(src).render_sharded(img, mesh=ref_make_mesh(1, 2, 1,
                                                                   devices=jax.devices()[:2]))
    got = mt.compile_source(src).render_sharded(img, mesh=mt.make_mesh(1, 2, 1,
                                                                       devices=["cpu"] * 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gaussian_blur_is_cached_per_render():
    """sharpen-like double use of one blur computes it once a render."""
    from mathmap_tpu_torch.runtime import native_filters as NF

    calls = []
    orig = NF.gaussian_blur_pixels

    def spy(pixels, stddev):
        calls.append(stddev)
        return orig(pixels, stddev)

    src = ("filter f (image in) b = gaussian_blur(in, 1.5); c = gaussian_blur(in, 1.5);"
           "b(xy) * 0.5 + c(xy + [1, 0]) * 0.5 end")
    NF.gaussian_blur_pixels = spy
    try:
        mt.compile_source(src).render(_image(), device="cpu")
    finally:
        NF.gaussian_blur_pixels = orig
    assert calls == [1.5]


def test_native_cache_pins_source_array():
    """The cache checks the pinned source tensor, not just its id(): a
    recycled id() must miss."""
    from mathmap_tpu_torch.runtime import native_filters as NF
    from mathmap_tpu_torch.runtime.tracer import RenderContext
    from mathmap_tpu_torch.runtime.value import InputImage, TupleValue

    ctx = RenderContext(device=torch.device("cpu"), width=8, height=8,
                        opts=mt.RenderOptions())

    class _Ev:
        def __init__(self):
            self.ctx = ctx

    ev = _Ev()
    a = torch.from_numpy(np.random.RandomState(3).rand(8, 8, 4).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(4).rand(8, 8, 4).astype(np.float32))
    sv = TupleValue("nil", (torch.tensor(2.0),), const=(2.0,))
    out_a = NF.native_gaussian_blur(ev, TupleValue("image", payload=InputImage(pixels=a)),
                                    sv, None)
    # an id() reused: b's id keys a's entry
    (key, ent), = ctx.native_cache.items()
    ctx.native_cache.clear()
    ctx.native_cache[(id(b), key[1])] = ent
    out_b = NF.native_gaussian_blur(ev, TupleValue("image", payload=InputImage(pixels=b)),
                                    sv, None)
    assert not torch.allclose(out_b.payload.pixels, out_a.payload.pixels)


# ---------------------------------------------------------------------------
# the composition gallery and user directories
# ---------------------------------------------------------------------------

def test_db_scans_mmc_compositions():
    db = default_db()
    assert not db.errors, db.errors
    assert db.entries["old_photo"].category == "Compositions"
    out = _render(db.compile("old_photo"), _image())
    assert out.shape == (H, W, 4) and np.isfinite(out).all()
    assert (out[..., 3] == 1).all()


def _composition_names():
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(ROOT, "filters", "Compositions", "*.mmc")))


@pytest.mark.parametrize("name", _composition_names())
def test_composition_gallery_renders(name):
    """Every bundled composition compiles through the port's composer and
    renders like the oracle's render of the reference database's entry."""
    f = default_db().compile(name)
    n_img = sum(1 for q in f.fdef.params if q.kind == "image")
    imgs = [_image()] * max(n_img, 1)
    out = _render(f, *imgs, options=NEAREST)
    assert out.shape == (H, W, 4) and np.isfinite(out).all()
    want = _oracle(ref_default_db().compile(name), *imgs, options=NEAREST)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_user_filter_dir_merges(tmp_path, monkeypatch):
    userdir = tmp_path / "exprs"
    userdir.mkdir()
    (userdir / "custom_probe.mm").write_text(
        "# user filter\nfilter custom_probe (image in) in(xy) end\n")
    monkeypatch.setenv("MMTPU_FILTER_PATH", str(userdir))
    db = default_db()
    assert "custom_probe" in db.entries and "custom_probe" in db.tree()


def test_user_mmc_references_bundled_filters(tmp_path, monkeypatch):
    """A user .mmc composition may reference bundled filters."""
    userdir = tmp_path / "exprs"
    userdir.mkdir()
    (userdir / "usercomp.mmc").write_text(
        '(composer (node "n1" "glass_tiles" (param "in" (input 0)) '
        '(param "size" 16)) (output "n1"))\n')
    monkeypatch.setenv("MMTPU_FILTER_PATH", str(userdir))
    db = default_db()
    assert not db.errors, db.errors
    assert np.isfinite(_render(db.compile("usercomp"), _image())).all()


def test_mmc_to_mmc_reference_order_independent(tmp_path, monkeypatch):
    """a.mmc may reference z.mmc (the scan retries until no progress)."""
    userdir = tmp_path / "exprs"
    userdir.mkdir()
    (userdir / "a_outer.mmc").write_text(
        '(composer (node "n1" "z_inner" (param "in0" (input 0))) (output "n1"))\n')
    (userdir / "z_inner.mmc").write_text(
        '(composer (node "n1" "grayscale" (param "in" (input 0))) (output "n1"))\n')
    monkeypatch.setenv("MMTPU_FILTER_PATH", str(userdir))
    db = default_db()
    assert not db.errors, db.errors
    assert "a_outer" in db.entries and "z_inner" in db.entries


def test_an_unresolvable_composition_is_recorded(tmp_path):
    (tmp_path / "bad.mmc").write_text('(composer (node "n1" "nope") (output "n1"))\n')
    db = ExpressionDB.scan(str(tmp_path))
    assert [os.path.basename(p) for p, _ in db.errors] == ["bad.mmc"]


def test_user_shadowing_keeps_tree_consistent(tmp_path, monkeypatch):
    """Shadowing a bundled filter moves its tree row to User/."""
    userdir = tmp_path / "exprs"
    userdir.mkdir()
    (userdir / "grayscale.mm").write_text(
        "# user grayscale\nfilter grayscale (image in) in(xy) end\n")
    monkeypatch.setenv("MMTPU_FILTER_PATH", str(userdir))
    db = default_db()
    entry = db.entries["grayscale"]
    assert entry.category.startswith("User")
    rows = [c for c, names in db.categories.items() if "grayscale" in names]
    assert rows == [entry.category], rows
