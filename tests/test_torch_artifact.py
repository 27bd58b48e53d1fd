"""Exported artifacts and the code generators of the port
(`mathmap_tpu_torch/generators/`) on the CPU, case for case with
tests/test_generators.py, plus the region round trip of
tests/test_region.py and what is the port's own: an artifact's program
calls kernels B1-B3 as the custom ops `mathmap::sample_image`,
`mathmap::apply_lut` and `mathmap::while_loop`, and `load_artifact`
imports no parser, evaluator or builtin table.

A loaded artifact's render equals the port's live render of the same
filter bit for bit (the artifact runs the same ops; atol=1e-6 where the
reference's test says so), and both are held against the JAX package's
NumPy oracle (`interpret=True`) at rtol=1e-4, atol=1e-5 on the same seeded
numpy inputs. The exports trace on the CPU (`device="cpu"`).
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.generators.artifact import (_MAGIC, _check_platform, export_artifact,
                                                   load_artifact)
from mathmap_tpu_torch.generators.standalone import export_program_text, export_python

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RTOL, ATOL = 1e-4, 1e-5
ART_SRC = ("filter tw (image in, float angle: -10-10 (3), color tint) "
           "c = in(toXY(ra:[r, a + angle * (1 - r / R) ^ 2])); c * tint end")
CURVE_SRC = ("filter c (image in, curve cv) "
             "grayColor(cv(clamp(abs(x / X), 0, 1))) end")
ANIM_SRC = ("filter an (image in, float k: 0-9 (2)) "
            "in(xy + xy:[k * sin(t * 2 * pi + y / 10), 0]) * "
            "grayColor(frame / 4 + 0.5) end")


def _export(f, path, w, h, **kw):
    export_artifact(f, str(path), w, h, device="cpu", **kw)
    return load_artifact(str(path))


def _live(f, *inputs, **kw):
    return f.render(*inputs, device="cpu", **kw)


def _oracle(src, *inputs, params=None, **kw):
    return np.asarray(mm.compile(src).render(*inputs, params=params, interpret=True, **kw))


def _ops(art) -> set:
    return {str(n.target) for n in art._program.graph.nodes if "mathmap" in str(n.target)}


def test_export_python_runs(tmp_path):
    f = mt.compile_file(os.path.join(ROOT, "filters", "Colors", "invert.mm"))
    script = tmp_path / "invert_standalone.py"
    export_python(f, str(script))
    img = np.random.RandomState(0).rand(8, 8, 4).astype(np.float32)
    inp, outp = tmp_path / "in.png", tmp_path / "out.png"
    mm.write_image(str(inp), img)
    env = {"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin", "MMTPU_PLATFORM": "cpu",
           "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, str(script), str(inp), str(outp), "--size", "8x8"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = mm.read_image(str(outp))
    expect = mm.read_image(str(inp))
    np.testing.assert_allclose(out[..., :3], 1 - expect[..., :3], atol=2 / 255)
    assert "import mathmap_tpu_torch" in script.read_text()


def test_export_program_text_contains_program():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Colors", "grayscale.mm"))
    text = export_program_text(f, 16, 16, device="cpu")
    assert "mathmap.sample_image" in text
    assert "f32[16, 16, 4]" in text


def test_from_pipeline_rejects_generative_mid_chain():
    from mathmap_tpu_torch.designer.graph import from_pipeline
    from mathmap_tpu_torch.utils.errors import MMRuntimeError

    db = mt.default_db()
    with pytest.raises(MMRuntimeError, match="generative"):
        from_pipeline("grayscale | moire | grayscale", db)
    g = from_pipeline("moire | grayscale", db)
    assert len(g.nodes) == 2


def test_composer_rejects_unknown_param_names():
    from mathmap_tpu_torch.designer.graph import from_pipeline
    from mathmap_tpu_torch.utils.errors import MMNameError

    db = mt.default_db()
    g = from_pipeline("twirl anlge=4.5", db)
    with pytest.raises(MMNameError, match="no parameter 'anlge'"):
        g.to_source()
    assert "twirl" in from_pipeline("twirl angle=4.5", db).to_source()


def test_load_mmc_counter_and_output_validation():
    from mathmap_tpu_torch.designer.graph import from_mmc
    from mathmap_tpu_torch.utils.errors import MMNameError, MMRuntimeError

    db = mt.default_db()
    g = from_mmc('(composer (node "n1" "grayscale" (param "in" (input 0)))'
                 ' (output "n1"))', db=db)
    assert g.add("twirl") == "n2"
    g.output = "zzz"
    with pytest.raises(MMNameError, match="unknown node"):
        g.to_source()
    with pytest.raises(MMRuntimeError, match="expected a number"):
        from_mmc('(composer (node "n1" "twirl" (param "angle" fast))'
                 ' (output "n1"))', db=db)


@pytest.fixture(scope="module")
def tw_art(tmp_path_factory):
    path = tmp_path_factory.mktemp("tw") / "tw.mmxa"
    return _export(mt.compile(ART_SRC), path, 48, 32,
                   params={"angle": 3.0, "tint": [1.0, 0.8, 0.6, 1.0]}), path


def test_artifact_roundtrip_params_stay_runtime(tw_art):
    """Export -> load -> render equals the live render bit for bit and the
    oracle within tolerance; param values change at call time."""
    art, _ = tw_art
    f = mt.compile(ART_SRC)
    img = np.random.RandomState(0).rand(32, 48, 4).astype(np.float32)
    for p in ({"angle": 3.0, "tint": [1.0, 0.8, 0.6, 1.0]},
              {"angle": 5.5, "tint": [0.2, 1.0, 0.4, 1.0]}):
        got = art.render(img, params=p, t=0.1)
        want = _live(f, img, width=48, height=32, t=0.1, params=p)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), _oracle(ART_SRC, img, params=p, t=0.1),
                                   rtol=RTOL, atol=ATOL)
    assert _ops(art) == {"mathmap.sample_image.default", "mathmap.libm.default",
                         "mathmap.finish_rgba.default"}


def test_artifact_curve_lut_param(tmp_path):
    f = mt.compile(CURVE_SRC)
    lut = (np.linspace(0, 1, 16) ** 2).astype(np.float32)
    art = _export(f, tmp_path / "c.mmxa", 48, 32, params={"cv": lut})
    img = np.random.RandomState(1).rand(32, 48, 4).astype(np.float32)
    half = (lut * 0.5).astype(np.float32)
    got = art.render(img, params={"cv": half})
    want = _live(f, img, width=48, height=32, params={"cv": half})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _oracle(CURVE_SRC, img, params={"cv": half}),
                               rtol=RTOL, atol=ATOL)
    assert "mathmap.apply_lut.default" in _ops(art)


def test_artifact_validation_errors(tw_art, tmp_path):
    art, _ = tw_art
    img = np.zeros((32, 48, 4), np.float32)
    with pytest.raises(ValueError, match="needs a value"):
        art.render(img, params={"angle": 1.0})
    with pytest.raises(ValueError, match="no param"):
        art.render(img, params={"angle": 1.0, "tint": [1, 1, 1, 1], "nope": 2})
    with pytest.raises(ValueError, match="input image"):
        art.render(params={"angle": 1.0, "tint": [1, 1, 1, 1]})
    with pytest.raises(ValueError, match="inputs must be"):
        art.render(np.zeros((8, 8, 4), np.float32), params={"angle": 1.0, "tint": [1, 1, 1, 1]})
    bad = tmp_path / "bad.mmxa"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a mathmap_tpu artifact"):
        load_artifact(str(bad))


def test_artifact_scalar_param_value_forms(tw_art):
    """0-d arrays, numpy scalars and length-1 arrays are accepted; values
    are converted as the live render converts them (clamped to the range)."""
    art, _ = tw_art
    img = np.random.RandomState(2).rand(32, 48, 4).astype(np.float32)
    base = art.render(img, params={"angle": 4.0, "tint": [1, 1, 1, 1]})
    for v in (np.array(4.0), np.float32(4.0), np.array([4.0])):
        got = art.render(img, params={"angle": v, "tint": np.ones(4, np.float32)})
        np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-6)
    clamped = art.render(img, params={"angle": 25.0, "tint": [1, 1, 1]})
    want = _live(mt.compile(ART_SRC), img, params={"angle": 25.0, "tint": [1, 1, 1]})
    assert torch.equal(clamped, want)


def test_artifact_truncated_files_raise_valueerror(tw_art, tmp_path):
    _, path = tw_art
    whole = path.read_bytes()
    cases = [_MAGIC + b"\x01", whole[:len(_MAGIC) + 4 + 10], whole[:-100]]
    for i, data in enumerate(cases):
        bad = tmp_path / f"bad{i}.mmxa"
        bad.write_bytes(data)
        with pytest.raises(ValueError, match="truncated|corrupt"):
            load_artifact(str(bad))


def _rewrite_manifest(path, dest, **fields):
    whole = path.read_bytes()
    (mlen,) = struct.unpack("<I", whole[len(_MAGIC):len(_MAGIC) + 4])
    body = len(_MAGIC) + 4 + mlen
    manifest = json.loads(whole[len(_MAGIC) + 4:body])
    manifest.update(fields)
    raw = json.dumps(manifest).encode()
    dest.write_bytes(_MAGIC + struct.pack("<I", len(raw)) + raw + whole[body:])
    return manifest


def test_artifact_platform_pin(tw_art, tmp_path, monkeypatch):
    """An artifact loaded where it was not exported fails at LOAD time with
    re-export guidance; the manifest records the device and torch."""
    _check_platform(("cpu",), "cpu", "x")
    _check_platform((), "cuda", "x")
    _check_platform(("CUDA",), "cuda", "x")
    with pytest.raises(ValueError, match="re-export"):
        _check_platform(("cuda",), "cpu", "x")
    art, path = tw_art
    assert art.platforms == ("cpu",)
    assert art.manifest["torch"] == torch.__version__
    assert art.manifest["has_grids"] is False
    pinned = tmp_path / "cuda_pinned.mmxa"
    manifest = _rewrite_manifest(path, pinned, platforms=["cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="platform.*re-export|re-export"):
            load_artifact(str(pinned))
    monkeypatch.setenv("MMTPU_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="re-export"):
        load_artifact(str(pinned))
    assert manifest["platforms"] == ["cuda"]
    # a program this torch cannot read back: the documented ValueError
    broken = tmp_path / "broken.mmxa"
    whole = path.read_bytes()
    broken.write_bytes(whole[:-64] + bytes(64))
    with pytest.raises(ValueError, match="Re-export"):
        load_artifact(str(broken))


def test_artifact_sampler_option_is_a_no_op(tmp_path):
    """The reference's sampler='pallas' shipped a second grids module; the
    port has no base layout (has_grids false), and the artifact still equals
    the live render under that option."""
    f = mt.compile(ART_SRC)
    opts = mt.RenderOptions(sampler="pallas")
    art = _export(f, tmp_path / "twp.mmxa", 64, 32, options=opts,
                  params={"angle": 3.0, "tint": [1, 1, 1, 1]})
    assert art.manifest["has_grids"] is False
    img = np.random.RandomState(3).rand(32, 64, 4).astype(np.float32)
    p = {"angle": 2.5, "tint": [0.9, 1.0, 0.8, 1.0]}
    got = art.render(img, params=p, t=0.2)
    want = _live(f, img, width=64, height=32, t=0.2, params=p, options=opts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _oracle(ART_SRC, img, params=p, t=0.2),
                               rtol=RTOL, atol=ATOL)


def test_artifact_render_batch_parity(tw_art, tmp_path):
    """render_batch equals per-job lone renders and the live render_batch
    bit for bit; u8 stacks normalise; oversized batches, a wrong frames
    length and an artifact without batch sizes raise."""
    f = mt.compile(ART_SRC)
    art = _export(f, tmp_path / "tw.mmxa", 48, 32,
                  params={"angle": 3.0, "tint": [1, 1, 1, 1]}, batch_sizes=(4,))
    assert art.batch_sizes == (4,)
    stack = np.random.RandomState(5).rand(3, 32, 48, 4).astype(np.float32)
    plist = [{"angle": a, "tint": [1, 0.9, 0.8, 1]} for a in (1.0, 2.5, 4.0)]
    ts = [0.0, 0.1, 0.2]
    got = art.render_batch(stack, params=plist, ts=ts)
    for i in range(3):
        want = _live(f, stack[i], width=48, height=32, t=ts[i], frame=float(i),
                     params=plist[i])
        assert torch.equal(got[i], want)
    live = f.render_batch(stack, ts=np.asarray(ts), width=48, height=32, params=plist,
                          device="cpu")
    assert torch.equal(got, live)
    u8 = (stack * 255).round().astype(np.uint8)
    assert torch.equal(art.render_batch(u8, params=plist, ts=ts),
                       art.render_batch(u8.astype(np.float32) / 255.0, params=plist, ts=ts))
    with pytest.raises(ValueError, match="exceeds the largest"):
        art.render_batch(np.zeros((5, 32, 48, 4), np.float32), params=plist[0],
                         ts=np.zeros(5))
    with pytest.raises(ValueError, match="frame values for 3 jobs"):
        art.render_batch(stack, params=plist, ts=ts, frames=[0.0, 1.0])
    nb, _ = tw_art
    with pytest.raises(ValueError, match="no batched programs"):
        nb.render_batch(stack, params=plist, ts=ts)


def test_artifact_render_animation_parity(tmp_path):
    """render_animation equals the live one bit for bit (t spacing and the
    frame internal fixed at export)."""
    f = mt.compile(ANIM_SRC)
    art = _export(f, tmp_path / "an.mmxa", 48, 32, params={"k": 2.0}, anim_frames=4)
    img = np.random.RandomState(6).rand(32, 48, 4).astype(np.float32)
    got = art.render_animation(img, params={"k": 3.0})
    want = f.render_animation(img, num_frames=4, width=48, height=32, params={"k": 3.0},
                              device="cpu")
    assert got.shape == (4, 32, 48, 4)
    assert torch.equal(got, want)
    for i in range(4):  # the oracle frame by frame: t = i/4, its frame internal i
        np.testing.assert_allclose(got[i].numpy(), _oracle(ANIM_SRC, img, params={"k": 3.0},
                                                           t=i / 4, frame=float(i)),
                                   rtol=RTOL, atol=ATOL)
    u8 = (img * 255).round().astype(np.uint8)
    assert torch.equal(art.render_animation(u8, params={"k": 3.0}),
                       art.render_animation(u8.astype(np.float32) / 255.0, params={"k": 3.0}))
    per = _export(f, tmp_path / "an_per.mmxa", 48, 32, params={"k": 2.0}, anim_frames=4,
                  options=mt.RenderOptions(periodic=False))
    gp = per.render_animation(img, params={"k": 3.0})
    wp = f.render_animation(img, num_frames=4, width=48, height=32, params={"k": 3.0},
                            options=mt.RenderOptions(periodic=False), device="cpu")
    assert torch.equal(gp, wp)
    assert not torch.equal(gp, got)
    na = _export(f, tmp_path / "na.mmxa", 48, 32, params={"k": 2.0})
    with pytest.raises(ValueError, match="no animation program"):
        na.render_animation(img, params={"k": 3.0})
    with pytest.raises(ValueError, match="anim_frames must be >= 1"):
        export_artifact(f, str(tmp_path / "z.mmxa"), 48, 32, anim_frames=0, device="cpu")


def test_region_artifact_roundtrip(tmp_path):
    """tests/test_region.py's round trip: the region is baked at export
    and the artifact renders the crop bit for bit."""
    rng = np.random.default_rng(7)
    img = rng.random((64, 256, 4)).astype(np.float32)
    img[..., 3] = 1.0
    warp = ("filter warp (image in) "
            "in(xy + xy:[0.1*sin(y*3), 0.1*cos(x*3)]) end")
    reg = (33, 7, 130, 41)
    f = mt.compile_source(warp)
    o = mt.RenderOptions(region=reg)
    art = _export(f, tmp_path / "r.mmxa", 256, 64, options=o)
    out = art.render(img)
    assert tuple(out.shape) == (41, 130, 4)
    assert torch.equal(out, _live(f, img, options=o))
    want = np.asarray(mm.compile_source(warp).render(
        img, interpret=True, options=mm.RenderOptions(region=reg)))
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


def test_exported_mandelbrot_calls_the_loop_op_and_equals_the_live_render(tmp_path):
    """A loop through kernel B3 exports as `mathmap::while_loop` (its op
    list the op's text argument) and B2 as `mathmap::apply_lut`; the
    artifact equals the live CPU render with params passed at call time."""
    path = os.path.join(ROOT, "filters", "Render", "mandelbrot.mm")
    f = mt.compile_file(path)
    p = {"maxiter": 40, "zoom": 2.0, "cx": -0.7}
    art = _export(f, tmp_path / "m.mmxa", 64, 48, params=p)
    assert {"mathmap.while_loop.default", "mathmap.apply_lut.default"} <= _ops(art)
    assert len(art.loops) == 1 and json.loads(art.loops[0])["ops"]
    for q in (p, {"maxiter": 60, "zoom": 1.3, "cx": -0.5}):
        got = art.render(params=q, t=0.3)
        want = _live(f, width=64, height=48, params=q, t=0.3)
        assert torch.equal(got, want)
        oracle = np.asarray(mm.compile_file(path).render(width=64, height=48, params=q,
                                                          t=0.3, interpret=True))
        np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


def test_a_masked_loop_exports(tmp_path):
    """A loop that runs as the masked eager loop (atan keeps it off kernel
    B3; `x * 0` keeps its trip count per pixel) exports as torch's
    `while_loop` op instead of raising: the artifact equals the live CPU
    render bit for bit and the oracle, at three t values for the source
    without params and three (n, t) settings with its trip count a
    runtime input."""
    src = ("filter m () s = 0; i = 0; while i < 3 + x * 0 do s = s + atan(y); "
           "i = i + 1 end; grayColor(s) end")
    with_n = ("filter mn (int n: 0-9 (3)) s = 0; i = 0; while i < n + x * 0 do "
              "s = s + atan(y + t); i = i + 1 end; grayColor(s / 9) end")
    for name, source, p_export, settings in (
            ("m", src, {}, [({}, 0.0), ({}, 0.3), ({}, 0.7)]),
            ("mn", with_n, {"n": 3}, [({"n": 3}, 0.0), ({"n": 1}, 0.3), ({"n": 7}, 0.7)])):
        f = mt.compile(source)
        art = _export(f, tmp_path / f"{name}.mmxa", 16, 8, params=p_export)
        assert any(n.target is torch.ops.higher_order.while_loop
                   for n in art._program.graph.nodes)
        assert "mathmap.while_loop.default" not in _ops(art)
        for p, t in settings:
            got = art.render(params=p, t=t)
            assert torch.equal(got, _live(f, width=16, height=8, params=p, t=t))
            oracle = np.asarray(mm.compile(source).render(width=16, height=8, params=p, t=t,
                                                          interpret=True))
            np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


def test_static_params_are_baked(tmp_path):
    """A static_params name is a constant of the program, not an input."""
    f = mt.compile(ART_SRC)
    opts = mt.RenderOptions(static_params=("angle",))
    p = {"angle": 4.0, "tint": [1, 1, 1, 1]}
    art = _export(f, tmp_path / "s.mmxa", 48, 32, options=opts, params=p)
    assert sorted(art.manifest["params"]) == ["tint"]
    img = np.random.RandomState(4).rand(32, 48, 4).astype(np.float32)
    got = art.render(img, params={"tint": [1, 1, 1, 1]})
    assert torch.equal(got, _live(f, img, options=opts, params=p))


def test_load_artifact_imports_no_compiler(tw_art):
    """load_artifact needs torch, numpy and the kernels' op modules only."""
    _, path = tw_art
    code = f"""
import sys
from mathmap_tpu_torch.generators.artifact import load_artifact
import numpy as np
art = load_artifact({str(path)!r})
out = art.render(np.zeros((32, 48, 4), np.float32), params={{"angle": 1.0, "tint": [1, 1, 1, 1]}})
mods = sorted(m for m in sys.modules if m.startswith("mathmap_tpu_torch"))
print(tuple(out.shape), mods)
banned = [m for m in mods if m.split(".")[1:2] and m.split(".")[1] in ("lang", "runtime", "api", "expression_db",
                                                    "designer", "parallel", "typesys")
          or m in ("mathmap_tpu_torch.ops.registry", "mathmap_tpu_torch.ops.builtins")]
assert not banned, banned
assert not any(m == "jax" or m.startswith("mathmap_tpu.") for m in sys.modules)
print("OK")
"""
    env = dict(os.environ, MMTPU_PLATFORM="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout and "(32, 48, 4)" in proc.stdout


def test_options_from_reference_export_like_the_reference(tmp_path):
    """A reference RenderOptions carries over to an export (bicubic, wrap)."""
    ro = mm.RenderOptions(interpolation="bicubic", edge_x="wrap", edge_y="reflect")
    f = mt.compile(ART_SRC)
    p = {"angle": -2.0, "tint": [1, 1, 1, 1]}
    art = _export(f, tmp_path / "o.mmxa", 40, 24, options=options_from_reference(ro), params=p)
    img = np.random.RandomState(9).rand(24, 40, 4).astype(np.float32)
    got = art.render(img, params=p)
    assert art.manifest["interpolation"] == "bicubic"
    assert art.manifest["edges"] == ["wrap", "reflect"]
    np.testing.assert_allclose(got.numpy(), _oracle(ART_SRC, img, params=p, options=ro),
                               rtol=RTOL, atol=ATOL)
