"""Exported artifacts of the loops that only the masked route runs, on the
CPU: a loop that kernel B3 refuses (its body calls noise, an image, atan
or holds another loop) and whose trip count is not a trace-time constant
exports as torch's `while_loop` op (runtime/loops.py::
while_loop_exported), the reference's lax route.

- ridged_noise with `octaves` and `scale` as runtime inputs at octaves 1, 4
  and 6; a feedback loop over the input image (a runtime trip count,
  origVal at a scaled xy every step); rand() in a loop B3 refuses, nested
  in a loop with a param-driven trip count (the inner draws salted with the
  outer iteration number, a tensor in the program); a loop the static
  unroll hands on after two steps; a loop that only `max_loop_iters` stops,
  the op's gate ending it exactly; a static nest that stays unrolled. Each artifact equals the live CPU
  render bit for bit and the JAX package's NumPy oracle (`interpret=True`)
  at rtol=1e-4, atol=1e-5 on the same seeded inputs.
- The tensor salts of such a loop against the int salts of the live route
  at salts 0, 1, 2^31 - 1, 2^31 and 2^32 - 1.
- Every library entry whose source has a `while`, `noise` or `rand`,
  exported with every numeric param as a runtime input, renders like its
  live render bit for bit (ridged_noise is the first case above, with the
  same runtime inputs). voronoi and lissajous are left out: their loops
  fold (a 3x3 scan, 64 steps), so they export through the static unroll as
  before this route existed, and each takes ~40 s to export and load here.
"""

import re

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
from mathmap_tpu_torch.ops import rand as R
from mathmap_tpu_torch.utils.trace import since, snapshot

RTOL, ATOL = 1e-4, 1e-5
W, H = 32, 24
TS = (0.0, 0.3)

FEEDBACK = ("filter feedback (image in, int n: 0-20 (6), float k: 0-2 (0.97)) c = in(xy); "
            "i = 0; p = xy; while i < n + x * 0 do p = p * k; c = (c + in(p)) * 0.5; "
            "i = i + 1 end; c end")
NESTED_RAND = ("filter nested_rand (int n: 1-9 (3)) s = 0; i = 0; while i < n do j = 0; "
               "while j < 2 + x * 0 do s = s + atan(rand(0, 1) + j); j = j + 1 end; "
               "i = i + 1 end; grayColor(s / 8) end")
#: `i + j < 5` folds for two steps, until j takes k, which is per pixel
#: from the first step: the masked route goes on from the third iteration
HANDOFF = ("filter handoff () i = 0; j = 0; k = 0; s = 0; while i + j < 5 do i = i + 1; "
           "j = k; k = x * 0 + (y > 0); s = s + rand(0, 1) * atan(y) end; grayColor(s) end")
#: a loop no pixel leaves before max_loop_iters
ENDLESS = ("filter endless (float g: 0-1 (0.5)) s = 0; while s < 1000 + x * 0 do "
           "s = s + atan(g + abs(y)) end; grayColor(s / 1000) end")

#: name -> (source, input image?, export params, render param settings, options)
CASES = {
    "ridged_noise": (None, False, {"octaves": 4, "scale": 120.0},
                     [{"octaves": 1, "scale": 120.0}, {"octaves": 4, "scale": 37.5},
                      {"octaves": 6, "scale": 120.0}], {}),
    "feedback": (FEEDBACK, True, {"n": 6, "k": 0.97},
                 [{"n": 6, "k": 0.97}, {"n": 1, "k": 0.5}, {"n": 9, "k": 1.1}], {}),
    # two steps an iteration (the default is four) keep the export of
    # this nest of traced loops quick; chip_smoke.py runs it at four
    "nested_rand": (NESTED_RAND, False, {"n": 3}, [{"n": 3}, {"n": 1}, {"n": 4}],
                    {"while_unroll": 2}),
    "handoff": (HANDOFF, False, {}, [{}], {}),
    "endless": (ENDLESS, False, {"g": 0.5}, [{"g": 0.5}, {"g": 0.25}],
                {"max_loop_iters": 13}),
}


def _source(name):
    src = CASES[name][0]
    if src is None:
        return mt.default_db().entries[name].source
    return src


def _image():
    return np.random.default_rng(3).random((H, W, 4)).astype(np.float32)


def _while_loops(art) -> int:
    return sum(n.target is torch.ops.higher_order.while_loop
               for n in art._program.graph.nodes)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (Filter, LoadedArtifact, the counters the export added),
    each case exported once for its param settings."""
    out = {}
    for name, (_, _, p_export, _, opts) in CASES.items():
        f = mt.compile(_source(name))
        path = tmp_path_factory.mktemp("loops") / f"{name}.mmxa"
        before = snapshot()
        export_artifact(f, str(path), W, H, params=p_export, device="cpu",
                        options=mt.RenderOptions(**opts))
        out[name] = (f, load_artifact(str(path)), since(before)["counters"])
    return out


@pytest.mark.parametrize("name,setting", [(n, k) for n, case in CASES.items()
                                          for k in range(len(case[3]))])
def test_an_exported_masked_loop_equals_the_live_render_and_the_oracle(exported, name,
                                                                       setting):
    _, with_image, _, settings, opts = CASES[name]
    f, art, counters = exported[name]
    # an export counts nothing (utils/trace.py): its graph names the route
    assert not counters
    assert _while_loops(art) >= 1 and not art.loops
    p = settings[setting]
    ins = (_image(),) if with_image else ()
    for t in TS:
        got = art.render(*ins, params=p, t=t)
        want = f.render(*ins, width=W, height=H, params=p, t=t, device="cpu",
                        options=mt.RenderOptions(**opts))
        assert torch.equal(got, want)
        oracle = mm.compile(_source(name)).render(*ins, width=W, height=H, params=p, t=t,
                                                  interpret=True,
                                                  options=mm.RenderOptions(**opts))
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=RTOL, atol=ATOL)


def test_the_static_unroll_hands_the_exported_loop_its_steps(exported):
    """HANDOFF's live render unrolls two steps, then masks one group of
    four numbered from 3: the artifact's loop starts from the same place.
    A frame after the first reads the loop's probe from its memo."""
    f, art, _ = exported["handoff"]
    f.render(width=W, height=H, device="cpu")
    before = snapshot()
    want = f.render(width=W, height=H, device="cpu")
    counters = since(before)["counters"]
    counters.pop("literal.cached", None)  # the constants already on the device
    assert counters == {"loop.masked": 1, "loop.masked.steps": 6, "probe.cached": 1,
                        "render.pixels": W * H, "render.samples": W * H, "render.walks": 1}
    assert _while_loops(art) == 1
    assert torch.equal(art.render(), want)


def test_the_gate_stops_the_exported_loop_at_max_loop_iters(exported):
    """ENDLESS under max_loop_iters=13 runs 13 steps, not the 16 of four
    whole groups: its artifact equals a loop of exactly 13 steps that the
    static unroll runs, and differs from 16 steps."""
    _, art, _ = exported["endless"]
    got = art.render(params={"g": 0.5})
    for n, same in ((13, True), (16, False)):
        counted = mt.compile(ENDLESS.replace("while s < 1000 + x * 0 do s =",
                                             f"i = 0; while i < {n} do i = i + 1; s ="))
        want = counted.render(width=W, height=H, params={"g": 0.5}, device="cpu")
        assert torch.equal(got, want) is same


def test_a_static_nest_stays_unrolled_in_an_export(tmp_path):
    """A 3x3 scan (voronoi's shape) whose bounds fold is unrolled in the
    export as in the live render: no while_loop op, the same pixels."""
    src = ("filter scan () s = 0; j = -1; while j <= 1 do i = -1; while i <= 1 do "
           "s = s + atan(x / 9 + i * j); i = i + 1 end; j = j + 1 end; grayColor(s / 9) end")
    f = mt.compile(src)
    export_artifact(f, str(tmp_path / "scan.mmxa"), W, H, device="cpu")
    art = load_artifact(str(tmp_path / "scan.mmxa"))
    assert _while_loops(art) == 0 and not art.loops
    before = snapshot()
    want = f.render(width=W, height=H, device="cpu")
    assert {k for k in since(before)["counters"] if k.startswith("loop.")} \
        == {"loop.unroll", "loop.unroll.steps"}
    assert torch.equal(art.render(), want)


SALTS = (0, 1, 2**31 - 1, 2**31, 2**32 - 1)


@pytest.mark.parametrize("salt", SALTS)
def test_a_tensor_salt_is_the_int_salt(salt):
    """An exported loop's iteration salt is a 0-d int64 tensor: mixing it
    and hashing with it give the int path's values, with no int64
    overflow, as the outer and as the inner salt."""
    index = R.rand_index((6, 7), 7, 3, 0, "cpu")
    as_tensor = torch.tensor(salt, dtype=torch.int64)
    for inner in (0, 1, 12345, 2**32 - 1):
        want = R.mix_salt(salt, inner)
        assert want == (salt * R.GOLDEN + inner) & R.M32
        assert int(R.mix_salt(as_tensor, inner)) == want
        assert int(R.mix_salt(inner, as_tensor)) == R.mix_salt(inner, salt)
    want = R.rand_uniform(index, R.draw_salt(7, 3), salt)
    assert torch.equal(R.rand_uniform(index, R.draw_salt(7, 3), as_tensor), want)


def _sweep_entries():
    db = mt.default_db()
    return [n for n, e in sorted(db.entries.items())
            if re.search(r"\b(while|noise|rand)\b", e.source)
            and n not in ("voronoi", "lissajous", "ridged_noise")]


def _runtime_params(f) -> dict:
    """Every numeric param at its default value (a colour at white)."""
    params = {}
    for p in f.params:
        if p.kind in ("int", "float", "bool"):
            params[p.name] = p.default if p.default is not None else (p.lo or 0)
        elif p.kind == "color":
            params[p.name] = list(p.default) if p.default is not None else [1, 1, 1, 1]
    return params


@pytest.mark.parametrize("name", _sweep_entries())
def test_library_entry_exports_with_its_params_as_inputs(name, tmp_path):
    f = mt.default_db().compile(name)
    params = _runtime_params(f)
    rng = np.random.default_rng(5)
    ins = [rng.random((12, 16, 4)).astype(np.float32) for _ in f.image_params]
    path = tmp_path / f"{name}.mmxa"
    export_artifact(f, str(path), 16, 12, params=params, device="cpu")
    art = load_artifact(str(path))
    assert sorted(art.manifest["params"]) == sorted(params)
    got = art.render(*ins, params=params, t=0.3)
    assert torch.equal(got, f.render(*ins, width=16, height=12, params=params, t=0.3,
                                     device="cpu"))
