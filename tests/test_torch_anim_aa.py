"""The antialiased animation deployment (`bench_torch/configs/
distort_anim_aa.json`, the cell `ripple_anim_1080p`) on the CPU at small
sizes: ripple and wave t-sweeps through `Filter.render_animation` with the
configuration's options (2x2 grid supersampling, bilinear, transparent
edges) over the cell's textured input.

- Each frame of a 6-frame 192x108 sweep against the benchmark's plain
  reference (`bench_torch/reference/supersample.py`), under the cell's own
  limits (`bench_torch/workloads/ripple_anim_1080p.json`), the params drawn
  as the cell's driver draws a call's (two seeds a filter) and at the ends
  of their ranges. The reference runs on one CPU thread (ROADMAP C5).
- Each frame of the sweep equals its lone `Filter.render` at the sweep's
  float32 t, bit for bit.
- One sample a pixel and the corners scheme each miss the reference by at
  least 100 times the cell's `worst_abs` limit: the texture makes the
  comparison see where the subsamples lie.
- The render layer's counters: `render.samples` s²·h·w (grid),
  (h+1)(w+1) + h·w (corners) or h·w (off) a frame, `render.walks` s², 2 or
  1, and F times that for an F-frame animation.
"""

import contextlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from bench_torch.drivers.animation import render_options
from bench_torch.drivers.sharded import draw_call, sweep_ts
from bench_torch.harness import compare, images, manifest
from mathmap_tpu_torch.utils import trace

CELL = "ripple_anim_1080p"
W, H, F = 192, 108, 6
CPU = torch.device("cpu")


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


def _spec(name):
    return next(f for f in _cell().config["filters"] if f["name"] == name)


def _options(**fields):
    return replace(render_options(mt, _cell().config), **fields)


def _image(seed=2**31 + 21):
    levels = int(_cell().config["input"]["levels"])
    return images.textured(images.smooth_image(W, H, seed, CPU), levels, seed)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _sweep(name, ps, image, **fields):
    f = mt.compile_source(_spec(name)["source"])
    return f.render_animation(image, num_frames=F, width=W, height=H, params=ps,
                              options=_options(**fields), device="cpu")


def _against_reference(name, ps, image, got):
    ref = manifest.reference(_spec(name)["reference"])
    comp = compare.Comparison()
    for i, t in enumerate(sweep_ts(F)):
        with _one_thread():
            want = ref(ps, float(t), W, H, image, torch.float32, CPU)
        comp.add(got[i], want)
    assert comp.answers == F
    return comp.numbers()


ENDS = {"ripple": ({"amplitude": 4.0, "wavelength": 40.0},
                   {"amplitude": 6.0, "wavelength": 60.0}),
        "wave": ({"amplitude": 6.0, "wavelength": 30.0},
                 {"amplitude": 10.0, "wavelength": 50.0})}
CASES = [(name, ("seed", s)) for name in ("ripple", "wave") for s in (2**31 + 3, 2**33 + 11)]
CASES += [(name, ("params", ps)) for name, ends in ENDS.items() for ps in ends]


def _params(name, how):
    if how[0] == "seed":
        return draw_call(_spec(name), np.random.default_rng([how[1], 1]), F)[0]
    return how[1]


@pytest.mark.parametrize("name,how", CASES,
                         ids=[f"{n}-{how[1] if how[0] == 'seed' else 'ends'}-{i}"
                              for i, (n, how) in enumerate(CASES)])
def test_sweep_holds_to_the_reference_under_the_cells_limits(name, how):
    ps, image = _params(name, how), _image()
    got = _sweep(name, ps, image)
    assert got.shape == (F, H, W, 4)
    ok, checks = compare.judge(_against_reference(name, ps, image, got),
                               _cell().settings["limits"])
    assert ok, checks


@pytest.mark.parametrize("name", ["ripple", "wave"])
def test_each_frame_equals_its_lone_render(name):
    ps, image = _params(name, ("seed", 2**32 + 5)), _image()
    got = _sweep(name, ps, image)
    f = mt.compile_source(_spec(name)["source"])
    for i, t in enumerate(sweep_ts(F)):
        want = f.render(image, width=W, height=H, t=float(t), params=ps,
                        options=_options(), device="cpu")
        assert torch.equal(got[i], want), i


@pytest.mark.parametrize("fields", [dict(supersample=1), dict(supersample_scheme="corners")],
                         ids=["one_sample", "corners"])
@pytest.mark.parametrize("name", ["ripple", "wave"])
def test_other_sampling_misses_the_reference_by_100x_the_limit(name, fields):
    ps, image = _params(name, ("seed", 2**31 + 3)), _image()
    numbers = _against_reference(name, ps, image, _sweep(name, ps, image, **fields))
    assert numbers["worst_abs"] >= 100 * _cell().settings["limits"]["worst_abs"], numbers


SCHEMES = [
    (dict(supersample=2), 4 * H * W, 4),
    (dict(supersample=3), 9 * H * W, 9),
    (dict(supersample=2, supersample_scheme="corners"), (H + 1) * (W + 1) + H * W, 2),
    (dict(supersample=3, supersample_scheme="corners"), (H + 1) * (W + 1) + H * W, 2),
    (dict(supersample=1), H * W, 1),
]


@pytest.mark.parametrize("frames", [1, 3], ids=["render", "animation"])
@pytest.mark.parametrize("fields,samples,walks", SCHEMES,
                         ids=["grid2", "grid3", "corners2", "corners3", "off"])
def test_the_render_layer_counts_samples_and_walks(fields, samples, walks, frames):
    f = mt.compile_source(_spec("ripple")["source"])
    image, opts = _image(), _options(**fields)
    before = trace.snapshot()
    if frames == 1:
        f.render(image, width=W, height=H, options=opts, device="cpu")
    else:
        f.render_animation(image, num_frames=frames, width=W, height=H, options=opts,
                           device="cpu")
    d = trace.since(before)
    assert d["counters"]["render.pixels"] == frames * H * W
    assert d["counters"]["render.samples"] == frames * samples
    assert d["counters"]["render.walks"] == frames * walks
    assert d["spans"]["mm.evaluate"]["count"] == frames * walks
