"""The noise deployment (`bench_torch/configs/noise_suite.json`, the cell
`noise.frames_4k`) on the CPU at small sizes: the port against the
benchmark's plain reference (`bench_torch/reference/noise.py`), and the
noise layer's spans and counters.

- `perlin3` against the reference's Perlin noise, written from Perlin's
  2002 `ImprovedNoise`, on negative coordinates, exact lattice points,
  coordinates one float32 step below an integer and voronoi's z = 0.5
  slice: both run the same float32 operations in the published order,
  so they agree bit for bit here; the tolerance, 1e-6 (about eight
  float32 steps of a value near 1), admits an elementwise op that rounds
  differently on another CPU, nothing more.
- turbulence and voronoi through `Filter.render(device="cpu")` at 160x90
  and 96x54, their params and t drawn as the cell draws them (three
  seeds) and at the ends of their ranges, against the reference under
  the cell's own limits (`bench_torch/workloads/noise.frames_4k.json`).
  voronoi reads ~1e-6, not 0: the port's CPU sqrt is numpy's, correctly
  rounded, the reference's torch's vectorised one, an ulp off at some
  inputs (ops/libm.py), and the edge's smoothstep scales that by up to
  ~19.
  The reference runs on one CPU thread: torch's CPU sqrt (MKL's vector
  sqrt over the intra-op threads) can return values ~1e-4 off in whole
  2048-element chunks on its first multi-threaded call in a process once
  another parallel op has run, so the first voronoi case of a process
  read ~3e-3 now and then (ROADMAP C5). The port's CPU sqrt is numpy's
  and is not affected.
- The records of one 160x90 frame: turbulence makes 4 `mm.noise` spans,
  voronoi 32. Its 3x3 scan calls noise 18 times, and the loop probes
  (`mm.loop.probe`, runtime/tracer.py::_eval_While) add 14: the outer
  loop's probe runs its body once, an inner loop of 2 calls in its own
  probe and 3 steps (8), and each of the 3 unrolled outer steps probes
  its inner loop once more (3 x 2). So 18 `mm.noise` spans have the
  parent `mm.evaluate` and 14 the parent `mm.loop.probe`, which opens 5
  times (1 + 1 inside it + 3). The next frame of the same filter finds
  the outer loop's outcome and the 3 inner ones in the loops' memos
  (`probe.cached` 4, runtime/loops.py::probe_outcome): it opens no
  `mm.loop.probe` (the inner probe inside the outer one goes with it) and
  makes the scan's 18 calls alone. `noise.points` is the calls times the
  frame's 14,400 pixels, `render.pixels` 14,400; a fisheye render makes
  no `mm.noise`.
"""

import contextlib

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from bench_torch.harness import compare, manifest, params
from bench_torch.reference import noise as ref
from mathmap_tpu_torch.ops import noise as N
from mathmap_tpu_torch.utils import trace

CELL = "noise.frames_4k"
TOL = 1e-6

_RS = np.random.RandomState(16)
_INTS = _RS.randint(-300, 300, (3, 2048)).astype(np.float32)
POINTS = {
    "random": _RS.uniform(-300, 300, (3, 8192)).astype(np.float32),
    "negative": -_RS.uniform(0, 300, (3, 4096)).astype(np.float32),
    "lattice": _INTS,
    "below_integer": np.nextafter(_INTS, np.float32(-np.inf)),
    "z_half": np.stack([_RS.uniform(-60, 60, 4096), _RS.uniform(-60, 60, 4096),
                        np.full(4096, 0.5)]).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(POINTS))
def test_perlin3_is_the_reference_perlin(name):
    x, y, z = (torch.from_numpy(a) for a in POINTS[name])
    got = N.perlin3(x, y, z)
    want = ref.perlin(x, y, z)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0.0, atol=TOL)


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


def _spec(name):
    return next(f for f in _cell().config["filters"] if f["name"] == name)


def _drawn(name, seed):
    """(params, t) as the cell's driver draws a call's."""
    rng = np.random.default_rng([seed, 1])
    return params.draw(_spec(name).get("params", {}), rng), params.draw_t(rng)


@contextlib.contextmanager
def _one_thread():
    """torch's CPU ops on one intra-op thread inside (ROADMAP C5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


CASES = [(f, size, ("seed", s)) for f in ("turbulence", "voronoi")
         for size in ((160, 90), (96, 54)) for s in (2**31 + 3, 2**32 + 7, 2**33 + 11)]
CASES += [("voronoi", (160, 90), ("params", {"cell": 70.0}, 0.9)),
          ("voronoi", (96, 54), ("params", {"cell": 110.0}, 0.1)),
          ("turbulence", (160, 90), ("params", {"scale": 60.0, "gain": 0.6}, 0.999)),
          ("turbulence", (96, 54), ("params", {"scale": 100.0, "gain": 0.4}, 0.0))]


@pytest.mark.parametrize("name,size,how", CASES,
                         ids=[f"{f}-{w}x{h}-{how[1] if how[0] == 'seed' else 'ends'}"
                              for f, (w, h), how in CASES])
def test_render_holds_to_the_reference_under_the_cells_limits(name, size, how):
    ps, t = _drawn(name, how[1]) if how[0] == "seed" else how[1:]
    w, h = size
    spec = _spec(name)
    got = mt.compile_source(spec["source"]).render(width=w, height=h, t=t, params=ps,
                                                   device="cpu")
    with _one_thread():
        want = manifest.reference(spec["reference"])(ps, t, w, h, None, torch.float32,
                                                      torch.device("cpu"))
    comp = compare.Comparison()
    comp.add(got, want)
    ok, checks = compare.judge(comp.numbers(), _cell().settings["limits"])
    assert ok, checks


#: of a filter's first (cold) and second (warm) frame: (noise calls, their
#: parents, the probes' count and parents or None, `probe.cached`)
FRAME = {"turbulence": [(4, {"mm.evaluate": 4}, None, 0)] * 2,
         "voronoi": [(32, {"mm.evaluate": 18, "mm.loop.probe": 14},
                      (5, {"mm.evaluate": 4, "mm.loop.probe": 1}), 0),
                     (18, {"mm.evaluate": 18}, None, 4)],
         "fisheye": [(0, {}, None, 0)] * 2}


@pytest.mark.parametrize("name", sorted(FRAME))
def test_one_frames_noise_spans_and_counters(name):
    if name == "fisheye":
        f, inputs = mt.compile_file("filters/Distorts/fisheye.mm"), (
            np.random.RandomState(5).rand(90, 160, 4).astype(np.float32),)
    else:
        f, inputs = mt.compile_source(_spec(name)["source"]), ()
    for calls, parents, probes, cached in FRAME[name]:
        before = trace.snapshot()
        f.render(*inputs, width=160, height=90, device="cpu")
        d = trace.since(before)
        noise = d["spans"].get("mm.noise", {"count": 0, "parents": {}})
        assert noise["count"] == calls
        assert noise["parents"] == parents
        assert d["counters"].get("noise.points", 0) == calls * 160 * 90
        assert d["counters"]["render.pixels"] == 160 * 90
        assert d["counters"].get("probe.cached", 0) == cached
        probe = d["spans"].get("mm.loop.probe")
        if probes is None:
            assert probe is None
        else:
            assert (probe["count"], probe["parents"]) == probes
