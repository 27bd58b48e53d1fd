"""The port's command-line renderer (mathmap_tpu_torch/cli.py) on the CPU.

The cases mirror tests/test_cli.py case for case, run in-process through
`cli.main(argv)` under MMTPU_PLATFORM=cpu, except `--fallback` (refused
here) and the animated-GIF input case; the artifact cases export on the
CPU and render the .mmxa. Each render's PNG (every
frame of a sequence) must be within 1 u8 level of the JAX CLI's
`--interpret` PNG for the same argv, run in-process too; a --param-sweep,
which the JAX CLI runs only on its jit path, is held against the NumPy
oracle's renders at each swept value. Two cases run `python -m
mathmap_tpu_torch` as a subprocess: a render, and a syntax error's exit
code.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.cli import main as ref_main
from mathmap_tpu_torch.cli import _parse_param_sweep, main
from mathmap_tpu_torch.imgio.images import read_animation, read_image, to_uint8, write_image

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("MMTPU_PLATFORM", "cpu")
    monkeypatch.chdir(ROOT)


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.png"
    img = np.random.RandomState(0).rand(20, 24, 4).astype(np.float32)
    img[..., 3] = 1.0
    write_image(str(path), img)
    return str(path)


def u8(path) -> np.ndarray:
    return read_animation(str(path), as_uint8=True)[0]


def run_both(tmp_path, argv, out_name="out.png", frames=1, interpret_ref=True):
    """Run the port's CLI and the JAX CLI (--interpret) on `argv`, whose
    "{out}" entry is the output path -> (port rc, reference rc, list of
    (port frame, reference frame) u8 pairs)."""
    mine, ref = tmp_path / "port", tmp_path / "ref"
    mine.mkdir(exist_ok=True)
    ref.mkdir(exist_ok=True)
    rc = main([a.replace("{out}", str(mine / out_name)) for a in argv])
    ref_argv = [a.replace("{out}", str(ref / out_name)) for a in argv]
    rrc = ref_main(ref_argv + (["--interpret"] if interpret_ref else []))
    root, ext = os.path.splitext(out_name)
    names = [out_name] if frames == 1 else [f"{root}_{i:04d}{ext}" for i in range(frames)]
    pairs = [(u8(mine / n), u8(ref / n)) for n in names] if rc == 0 else []
    return rc, rrc, pairs


def within_one_level(pairs):
    assert pairs
    for got, want in pairs:
        assert got.shape == want.shape
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_render_expression(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["grayColor(gray(origVal(xy)))", input_png, "{out}",
                                         "--interpret"])
    assert rc == rrc == 0
    within_one_level(pairs)
    img = pairs[0][0]
    assert img.shape == (20, 24, 4)
    assert np.array_equal(img[..., 0], img[..., 1])  # gray


def test_render_library_filter_with_param(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["invert", input_png, "{out}"])
    assert rc == rrc == 0
    within_one_level(pairs)
    orig = u8(input_png)
    assert np.abs(pairs[0][0][..., :3].astype(int) + orig[..., :3] - 255).max() <= 1


def test_animation_frames_and_resume(input_png, tmp_path, capsys):
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/wave.mm", input_png, "{out}",
                                         "--frames", "2"], out_name="anim.png", frames=2)
    assert rc == rrc == 0
    within_one_level(pairs)
    out = tmp_path / "port" / "anim.png"
    capsys.readouterr()
    assert main(["filters/Distorts/wave.mm", input_png, str(out), "--frames", "2",
                 "--resume", "-v"]) == 0
    assert "0 frame(s)" in capsys.readouterr().err


def test_list_flag(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "Distorts/" in out and "fisheye" in out


def test_syntax_error_exit_code_in_process(input_png, tmp_path, capsys):
    assert main(["grayColor(1 +", input_png, str(tmp_path / "x.png")]) == 1
    assert "MMSyntaxError" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_missing_output():
    with pytest.raises(SystemExit) as e:
        main(["grayColor(x)"])
    assert e.value.code != 0


def test_edge_and_interp_flags(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["origVal(xy + xy:[30, 0])", input_png, "{out}",
                                         "--interpret", "--edge-x", "wrap",
                                         "--interpolation", "nearest"])
    assert rc == rrc == 0
    within_one_level(pairs)
    orig = u8(input_png)
    np.testing.assert_array_equal(pairs[0][0], np.roll(orig, -(30 % 24), axis=1))


def test_two_input_blend_cli(input_png, tmp_path):
    second = tmp_path / "b.png"
    write_image(str(second), np.ones((20, 24, 4), np.float32))
    rc, rrc, pairs = run_both(tmp_path, ["blend", input_png, str(second), "{out}",
                                         "--param", "factor=0.5"])
    assert rc == rrc == 0
    within_one_level(pairs)
    orig = read_image(input_png)
    np.testing.assert_allclose(pairs[0][0][..., :3] / 255.0, (orig[..., :3] + 1) / 2,
                               atol=2 / 255)


def _dir_of_images(tmp_path):
    ind = tmp_path / "ins"
    ind.mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        write_image(str(ind / f"img{i}.png"), rng.rand(12, 16, 4).astype(np.float32))
    write_image(str(ind / "wide.png"), rng.rand(12, 32, 4).astype(np.float32))
    return ind


def test_input_dir_batch_mode(tmp_path, capsys):
    ind = _dir_of_images(tmp_path)
    outd, refd = tmp_path / "outs", tmp_path / "refs"
    assert main(["filters/Colors/invert.mm", str(outd), "--input-dir", str(ind),
                 "--batch-size", "2", "-v"]) == 0
    assert "batch group" in capsys.readouterr().err
    assert ref_main(["filters/Colors/invert.mm", str(refd), "--input-dir", str(ind),
                     "--interpret"]) == 0
    outs = sorted(os.listdir(outd))
    assert outs == ["img0.png", "img1.png", "img2.png", "wide.png"]
    within_one_level([(u8(outd / n), u8(refd / n)) for n in outs])
    orig, got = u8(ind / "img1.png"), u8(outd / "img1.png")
    assert np.abs(got[..., :3].astype(int) + orig[..., :3] - 255).max() <= 1
    # resume: a second run writes nothing new
    m0 = {n: os.path.getmtime(outd / n) for n in outs}
    assert main(["filters/Colors/invert.mm", str(outd), "--input-dir", str(ind),
                 "--resume"]) == 0
    assert {n: os.path.getmtime(outd / n) for n in outs} == m0


def test_input_dir_batch_renders_at_frame_zero(tmp_path):
    ind, outd = tmp_path / "ins", tmp_path / "outs"
    ind.mkdir()
    src = tmp_path / "framefilt.mm"
    src.write_text("filter framefilt (image in) "
                   "in(xy) * 0 + grayColor(0.25 + frame * 0.2) end\n")
    for i in range(3):
        write_image(str(ind / f"img{i}.png"), np.full((8, 8, 4), 0.5, np.float32))
    assert main([str(src), str(outd), "--input-dir", str(ind), "--batch-size", "3"]) == 0
    for i in range(3):
        v = u8(outd / f"img{i}.png")[..., 0]
        assert np.abs(v.astype(int) - round(0.25 * 255)).max() <= 1, i


def test_unknown_param_rejected(tmp_path):
    p = tmp_path / "in_up.png"
    write_image(str(p), np.zeros((8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="unknown param"):
        main(["twirl", str(p), str(tmp_path / "o.png"), "--param", "raduis=5"])


def test_tiled_flag_matches_plain(input_png, tmp_path):
    a, b = tmp_path / "tiled.png", tmp_path / "plain.png"
    assert main(["filters/Distorts/ripple.mm", input_png, str(a), "--tiled", "--halo",
                 "auto", "--param", "amplitude=2"]) == 0
    assert main(["filters/Distorts/ripple.mm", input_png, str(b),
                 "--param", "amplitude=2"]) == 0
    np.testing.assert_array_equal(u8(a), u8(b))
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/ripple.mm", input_png, "{out}",
                                         "--tiled", "--param", "amplitude=2"])
    assert rc == rrc == 0
    within_one_level(pairs)


def test_tiled_animation_frames(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/ripple.mm", input_png, "{out}",
                                         "--tiled", "--frames", "2"], out_name="anim.png",
                              frames=2)
    assert rc == rrc == 0
    within_one_level(pairs)


def test_tiled_region_renders_selection_in_place(input_png, tmp_path):
    a, b = tmp_path / "treg.png", tmp_path / "plain.png"
    assert main(["filters/Distorts/ripple.mm", input_png, str(a), "--tiled", "--halo",
                 "auto", "--region", "3,4,10x8"]) == 0
    assert main(["filters/Distorts/ripple.mm", input_png, str(b)]) == 0
    got, plain, src = u8(a), u8(b), u8(input_png)
    assert got.shape == src.shape  # full canvas, not the crop
    np.testing.assert_array_equal(got[4:12, 3:13], plain[4:12, 3:13])
    mask = np.zeros(src.shape[:2] + (1,), bool)
    mask[4:12, 3:13] = True
    np.testing.assert_array_equal(np.where(mask, src, got), src)


def test_tiled_sharded_conflict(input_png, tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["filters/Distorts/ripple.mm", input_png, str(tmp_path / "x.png"), "--tiled",
              "--sharded"])


def test_tiled_bad_halo(input_png, tmp_path):
    with pytest.raises(SystemExit, match="--halo expects"):
        main(["filters/Distorts/ripple.mm", input_png, str(tmp_path / "x.png"), "--tiled",
              "--halo", "zz"])


def test_cli_tiled_png_sequence_routes_tiled(tmp_path, monkeypatch):
    img = tmp_path / "in.png"
    write_image(str(img), np.full((16, 16, 4), 90, np.uint8))
    calls = {"tiled": 0}
    orig = mt.Filter.render_tiled

    def counting(self, *a, **kw):
        calls["tiled"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(mt.Filter, "render_tiled", counting)
    assert main(["origVal(xy)", str(img), str(tmp_path / "out.png"), "--tiled",
                 "--frames", "2"]) == 0
    assert calls["tiled"] == 2
    for i in range(2):
        assert (tmp_path / f"out_{i:04d}.png").exists()


def test_cli_selftest_runs_clean(capsys):
    assert main(["--selftest", "--size", "64x64"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "10/10 passed" in out


def test_artifacts_are_refused_with_the_roadmap_item(input_png, tmp_path, capsys):
    """Once refused naming ROADMAP A10: the three argv forms it pinned now
    export an artifact (with batch sizes) and render one, rc 0."""
    art = tmp_path / "t.mmxa"
    for argv in (["filters/Distorts/twirl.mm", "--export-artifact", str(art), "--size", "24x20"],
                 [str(art), input_png, str(tmp_path / "o.png")],
                 ["filters/Distorts/twirl.mm", "--export-artifact", str(tmp_path / "b.mmxa"),
                  "--size", "24x20", "--artifact-batch-sizes", "2,4"]):
        assert main(argv) == 0
        err = capsys.readouterr().err
        assert "ROADMAP A10" not in err and "Traceback" not in err
    assert (tmp_path / "o.png").exists() and (tmp_path / "b.mmxa").exists()


def test_export_and_render_artifact(input_png, tmp_path):
    """--export-artifact writes a .mmxa; rendering from it (no compiler
    path) equals the live CLI render bit for bit at uint8, and the JAX
    CLI's --interpret render within 1 level."""
    art = tmp_path / "tw.mmxa"
    assert main(["filters/Distorts/twirl.mm", "--export-artifact", str(art), "--size", "24x20",
                 "--param", "angle=3", "--artifact-batch-sizes", "2,4"]) == 0
    assert art.exists()
    from mathmap_tpu_torch.generators.artifact import load_artifact

    assert load_artifact(str(art)).batch_sizes == (2, 4)
    out_a, out_l, out_r = tmp_path / "a.png", tmp_path / "l.png", tmp_path / "r.png"
    assert main([str(art), input_png, str(out_a), "--param", "angle=5"]) == 0
    assert main(["filters/Distorts/twirl.mm", input_png, str(out_l), "--size", "24x20",
                 "--param", "angle=5"]) == 0
    np.testing.assert_array_equal(u8(out_a), u8(out_l))
    assert ref_main(["filters/Distorts/twirl.mm", input_png, str(out_r), "--size", "24x20",
                     "--param", "angle=5", "--interpret"]) == 0
    within_one_level([(u8(out_a), u8(out_r))])


def test_artifact_animation_cli(tmp_path):
    art = tmp_path / "g.mmxa"
    assert main(["filter g () grayColor(t) end", "--export-artifact", str(art), "--size",
                 "16x12", "--frames", "3"]) == 0
    gif = tmp_path / "g.gif"
    assert main([str(art), str(gif), "--frames", "3"]) == 0
    assert read_animation(str(gif), as_uint8=True).shape[0] == 3
    # a frame sequence needs no Pillow: each frame is the live sweep's
    assert main([str(art), str(tmp_path / "s.png"), "--frames", "3"]) == 0
    live = mt.compile("filter g () grayColor(t) end").render_animation(
        num_frames=3, width=16, height=12, device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(u8(tmp_path / f"s_{i:04d}.png"), to_uint8(live[i]))
    # a frame-count mismatch is a clear error, not a wrong render
    with pytest.raises(SystemExit, match="re-export"):
        main([str(art), str(tmp_path / "x.gif"), "--frames", "5"])


def test_artifact_cli_error_paths(tmp_path, capsys):
    """A missing .mmxa and an export from an artifact give one-line
    errors, not tracebacks."""
    assert main([str(tmp_path / "typo.mmxa"), str(tmp_path / "out.png")]) == 1
    err = capsys.readouterr().err
    assert "Traceback" not in err and err.count("\n") == 1
    with pytest.raises(SystemExit, match="cannot --export-artifact"):
        main([str(tmp_path / "typo.mmxa"), "--export-artifact", str(tmp_path / "new.mmxa")])


def test_artifact_of_another_platform_is_refused(input_png, tmp_path, capsys, monkeypatch):
    """An artifact exported on the CPU renders on the CPU only: with the
    GPU as the CLI's device it is refused at load time (simulated by the
    platform recorded in the manifest)."""
    import struct

    from mathmap_tpu_torch.generators.artifact import _MAGIC

    art = tmp_path / "tw.mmxa"
    assert main(["filters/Distorts/twirl.mm", "--export-artifact", str(art), "--size",
                 "24x20"]) == 0
    whole = art.read_bytes()
    (n,) = struct.unpack("<I", whole[len(_MAGIC):len(_MAGIC) + 4])
    manifest = json.loads(whole[len(_MAGIC) + 4:len(_MAGIC) + 4 + n])
    manifest["platforms"] = ["cuda"]
    raw = json.dumps(manifest).encode()
    art.write_bytes(_MAGIC + struct.pack("<I", len(raw)) + raw + whole[len(_MAGIC) + 4 + n:])
    assert main([str(art), input_png, str(tmp_path / "o.png")]) == 1
    err = capsys.readouterr().err
    assert "re-export" in err and "Traceback" not in err


def test_fallback_is_refused(input_png, tmp_path):
    with pytest.raises(SystemExit, match="--fallback is not supported"):
        main(["invert", input_png, str(tmp_path / "o.png"), "--fallback"])


def test_platform_switch(input_png, tmp_path, monkeypatch):
    """Only MMTPU_PLATFORM=cpu (or --interpret) renders on the CPU: any
    other value, or a machine without a GPU and without the variable,
    raises before rendering."""
    out = tmp_path / "o.png"
    monkeypatch.setenv("MMTPU_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="MMTPU_PLATFORM"):
        main(["invert", input_png, str(out)])
    monkeypatch.delenv("MMTPU_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA GPU"):
            main(["invert", input_png, str(out)])
        assert not out.exists()
    assert main(["invert", input_png, str(out), "--interpret"]) == 0


def test_param_sweep_gif(input_png, tmp_path):
    pytest.importorskip("PIL")  # GIF output needs Pillow
    gif = tmp_path / "sweep.gif"
    assert main(["filters/Distorts/twirl.mm", input_png, str(gif), "--param-sweep",
                 "angle=1:5", "--frames", "4"]) == 0
    assert read_animation(str(gif), as_uint8=True).shape[0] == 4


def _oracle_u8(src_path, img, **kw):
    return to_uint8(np.asarray(mm.compile_file(src_path).render(img, interpret=True, **kw)))


def test_param_sweep_sequence_matches_per_frame(input_png, tmp_path):
    seq = tmp_path / "s.png"
    assert main(["filters/Distorts/twirl.mm", input_png, str(seq), "--param-sweep",
                 "angle=1:5", "--frames", "3"]) == 0
    f = mt.compile_file("filters/Distorts/twirl.mm")
    img = read_image(input_png)
    for i, v in enumerate((1.0, 3.0, 5.0)):
        got = u8(tmp_path / f"s_{i:04d}.png")
        lone = to_uint8(f.render(img, t=0.0, frame=float(i), params={"angle": v},
                                 device="cpu"))
        np.testing.assert_array_equal(got, lone)
        want = _oracle_u8("filters/Distorts/twirl.mm", img, frame=float(i),
                          params={"angle": v})
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_param_sweep_with_region(input_png, tmp_path):
    seq = tmp_path / "sr.png"
    assert main(["filters/Distorts/twirl.mm", input_png, str(seq), "--param-sweep",
                 "angle=1:5", "--frames", "3", "--region", "3,4,10x8"]) == 0
    f = mt.compile_file("filters/Distorts/twirl.mm")
    img = read_image(input_png)
    opts = mt.RenderOptions(region=(3, 4, 10, 8))
    for i, v in enumerate((1.0, 3.0, 5.0)):
        got = u8(tmp_path / f"sr_{i:04d}.png")
        assert got.shape[:2] == (8, 10)
        lone = to_uint8(f.render(img, t=0.0, frame=float(i), params={"angle": v},
                                 options=opts, device="cpu"))
        np.testing.assert_array_equal(got, lone)
        want = _oracle_u8("filters/Distorts/twirl.mm", img, frame=float(i),
                          params={"angle": v}, options=mm.RenderOptions(region=(3, 4, 10, 8)))
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_param_sweep_errors(input_png, tmp_path):
    out = str(tmp_path / "o.png")
    base = ["filters/Distorts/twirl.mm", input_png, out]
    with pytest.raises(SystemExit, match="no param"):
        main(base + ["--param-sweep", "nosuch=0:1", "--frames", "3"])
    with pytest.raises(SystemExit, match="NAME=LO:HI"):
        main(base + ["--param-sweep", "angle=3", "--frames", "3"])
    with pytest.raises(SystemExit, match="--frames"):
        main(base + ["--param-sweep", "angle=1:5"])
    # --interpret only moves the sweep to the CPU here: it combines
    assert main(base + ["--param-sweep", "angle=1:5", "--frames", "2", "--interpret"]) == 0


def test_param_sweep_batch_conflict(input_png, tmp_path):
    with pytest.raises(SystemExit, match="does not combine"):
        main(["filters/Distorts/twirl.mm", input_png, str(tmp_path / "o.png"),
              "--param-sweep", "angle=1:5", "--frames", "3", "--batch"])


def test_param_sweep_int_rounding_half_up():
    f = mt.compile_source("filter g (int k: 0-5 (0)) grayColor(k/5) end")
    _, vals = _parse_param_sweep("k=0:5", f, 11)
    assert vals == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5]


def test_region_render(tmp_path):
    expr = "filter g () rgbaColor(x/W+0.5, y/H+0.5, 0.3, 1) end"
    rc, rrc, pairs = run_both(tmp_path, [expr, "{out}", "--size", "128x96",
                                         "--region", "17,9,50x40"])
    assert rc == rrc == 0
    within_one_level(pairs)
    full = tmp_path / "full.png"
    assert main([expr, str(full), "--size", "128x96"]) == 0
    reg = pairs[0][0]
    assert reg.shape == (40, 50, 4)
    assert np.array_equal(reg, u8(full)[9:49, 17:67])


def test_region_errors(tmp_path, capsys):
    out = str(tmp_path / "o.png")
    expr = "filter g () rgbaColor(x,y,0,1) end"
    assert main([expr, out, "--size", "32x32", "--region", "30,0,10x4"]) == 1
    assert "exceeds the 32x32 canvas" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="X,Y,WxH"):
        main([expr, out, "--size", "32x32", "--region", "bogus"])
    with pytest.raises(SystemExit, match="--tiled"):
        main([expr, out, "--size", "32x32", "--region", "0,0,8x8", "--sharded"])
    for bad in ("-1,0,8x8", "0,-3,8x8", "0,0,0x8", "0,0,8x0"):
        with pytest.raises(SystemExit, match="X,Y,WxH"):
            main([expr, out, "--size", "32x32", f"--region={bad}"])


def test_size_and_edge_color_errors_are_one_line(tmp_path):
    out = tmp_path / "o.png"
    expr = "filter g () rgbaColor(x,y,0,1) end"
    assert main([expr, str(out), "--size", "24", "--interpret"]) == 0
    assert u8(out).shape == (24, 24, 4)
    for argv in (("--size", "abc"), ("--size", "8x"), ("--size", "0x8"),
                 ("--edge-color", "1,z"), ("--edge-color", "1,2")):
        with pytest.raises(SystemExit) as e:
            main([expr, str(out), *argv])
        assert isinstance(e.value.code, str) and "\n" not in e.value.code, argv


def test_tiled_region_interpret_keeps_inplace_contract(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/ripple.mm", input_png, "{out}",
                                         "--tiled", "--halo", "auto", "--region",
                                         "3,4,10x8", "--interpret"])
    assert rc == rrc == 0
    within_one_level(pairs)
    got, src = pairs[0][0], u8(input_png)
    assert got.shape == src.shape
    mask = np.zeros(src.shape[:2] + (1,), bool)
    mask[4:12, 3:13] = True
    np.testing.assert_array_equal(np.where(mask, src, got), src)
    crop = tmp_path / "crop.png"
    assert main(["filters/Distorts/ripple.mm", input_png, str(crop), "--region",
                 "3,4,10x8", "--interpret"]) == 0
    np.testing.assert_array_equal(got[4:12, 3:13], u8(crop))


def test_chain_with_region(input_png, tmp_path):
    a, b = tmp_path / "cr.png", tmp_path / "cf.png"
    assert main(["--chain", "ripple|invert", input_png, str(a), "--region", "3,4,10x8"]) == 0
    assert main(["--chain", "ripple|invert", input_png, str(b)]) == 0
    got, full = u8(a), u8(b)
    assert got.shape == (8, 10, 4)
    np.testing.assert_array_equal(got, full[4:12, 3:13])
    rc, rrc, pairs = run_both(tmp_path, ["--chain", "ripple|invert", input_png, "{out}",
                                         "--region", "3,4,10x8"])
    assert rc == rrc == 0
    within_one_level(pairs)


# -- flags the reference's tests do not reach ---------------------------------

@pytest.mark.parametrize("extra", [["--batch"], ["--sharded"], ["--sharded", "--batch"]],
                         ids=["batch", "sharded", "sharded_batch"])
def test_sweep_routes_match_the_reference(input_png, tmp_path, extra):
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/ripple.mm", input_png, "{out}",
                                         "--frames", "3", *extra], out_name="s.png", frames=3)
    assert rc == rrc == 0
    within_one_level(pairs)


def test_supersample_corners_and_u8_output(input_png, tmp_path):
    rc, rrc, pairs = run_both(tmp_path, ["filters/Distorts/twirl.mm", input_png, "{out}",
                                         "--supersample", "--supersample-scheme", "corners",
                                         "--output-dtype", "uint8", "--param", "angle=2"])
    assert rc == rrc == 0
    within_one_level(pairs)


def test_chain_save_and_mmc(input_png, tmp_path):
    mmc = tmp_path / "c.mmc"
    a = tmp_path / "a.png"
    assert main(["--chain", "ripple|invert", input_png, str(a), "--save-chain", str(mmc)]) == 0
    b = tmp_path / "b.png"
    assert main([str(mmc), input_png, str(b)]) == 0
    np.testing.assert_array_equal(u8(a), u8(b))


def test_stats_and_profile(input_png, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert main(["invert", input_png, str(tmp_path / "o.png"), "--stats", "--profile",
                 str(trace)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["width"] == 24 and stats["height"] == 20 and stats["frames"] == 1
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]


def test_gif_output_of_a_sweep(input_png, tmp_path):
    pytest.importorskip("PIL")  # GIF output needs Pillow
    gif = tmp_path / "a.gif"
    assert main(["filters/Distorts/ripple.mm", input_png, str(gif), "--frames", "3"]) == 0
    assert read_animation(str(gif), as_uint8=True).shape == (3, 20, 24, 4)


# -- subprocesses -------------------------------------------------------------

def _run(*args):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "MMTPU_PLATFORM": "cpu",
           "HOME": os.environ.get("HOME", "/tmp"), "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "mathmap_tpu_torch", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_python_dash_m_renders(input_png, tmp_path):
    out = tmp_path / "tw.png"
    proc = _run("filters/Distorts/twirl.mm", input_png, str(out), "--param", "angle=5")
    assert proc.returncode == 0, proc.stderr[-1000:]
    f = mt.compile_file(os.path.join(ROOT, "filters/Distorts/twirl.mm"))
    want = to_uint8(f.render(read_image(input_png), params={"angle": 5}, device="cpu"))
    np.testing.assert_array_equal(u8(out), want)


def test_python_dash_m_syntax_error_exit_code(input_png, tmp_path):
    proc = _run("grayColor(1 +", input_png, str(tmp_path / "x.png"))
    assert proc.returncode == 1
    assert "MMSyntaxError" in proc.stderr and "Traceback" not in proc.stderr
    assert not (tmp_path / "x.png").exists()
