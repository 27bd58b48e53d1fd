"""The four-card animation deployment (`bench_torch/configs/
distort_sweep_4card.json`, the cell `distort.sharded_4chip`) on the CPU at
small sizes: a ripple and twirl t-sweep through `Filter.render_sharded` on
a (1,4,1) mesh of "cpu" entries, the frames' rows split four ways.

- Each frame of an 8-frame 160x96 sweep against the benchmark's plain
  reference (`bench_torch/reference/ripple.py`, `polar.py`), which renders
  the whole frame on one device, under the cell's own limits
  (`bench_torch/workloads/distort.sharded_4chip.json`), the params drawn
  as the cell's driver draws a call's (three seeds) and at the ends of
  their ranges. The reference runs on one CPU thread (ROADMAP C5).
- The sweep equals `render_animation` on one device bit for bit: a tile
  builds the whole frame's coordinates for its rows.
- The parallel layer's records of one sweep of F frames over 4 tiles: F
  `mm.frame` (in `mm.call`), 4F `mm.shard.tile` (in `mm.frame`), F
  `mm.shard.assemble`, one `mm.shard.replicate` (the mesh's one device),
  `shard.tiles` 4F and no `shard.peer_bytes`; a `render_tiled` frame one
  `mm.shard.assemble`; a `Filter.render` no `mm.shard.*` and no `shard.*`.
- A copy to another device counts its bytes in `shard.peer_bytes`, and one
  that stays does not (the "meta" device stands in for a second card).
"""

import contextlib

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from bench_torch.drivers.sharded import draw_call, sweep_ts
from bench_torch.harness import compare, images, manifest
from mathmap_tpu_torch.parallel.mesh import peer_copy
from mathmap_tpu_torch.utils import trace

CELL = "distort.sharded_4chip"
W, H, F = 160, 96, 8
CPU = torch.device("cpu")


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


def _spec(name):
    return next(f for f in _cell().config["filters"] if f["name"] == name)


def _mesh():
    return mt.make_mesh(1, 4, 1, devices=["cpu"] * 4)


def _image(seed=2**31 + 1):
    return images.smooth_image(W, H, seed, CPU)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _sweep(name, ps, image):
    f = mt.compile_source(_spec(name)["source"])
    return f.render_sharded(image, mesh=_mesh(), num_frames=F, width=W, height=H, params=ps)


ENDS = {"ripple": ({"amplitude": 4.0, "wavelength": 40.0},
                   {"amplitude": 6.0, "wavelength": 60.0}),
        "twirl": ({"angle": 2.0}, {"angle": 4.0})}
CASES = [(name, ("seed", s)) for name in ("ripple", "twirl")
         for s in (2**31 + 3, 2**32 + 7, 2**33 + 11)]
CASES += [(name, ("params", ps)) for name, ends in ENDS.items() for ps in ends]


@pytest.mark.parametrize("name,how", CASES,
                         ids=[f"{n}-{how[1] if how[0] == 'seed' else 'ends'}-{i}"
                              for i, (n, how) in enumerate(CASES)])
def test_sweep_holds_to_the_reference_under_the_cells_limits(name, how):
    spec = _spec(name)
    if how[0] == "seed":
        ps, _ = draw_call(spec, np.random.default_rng([how[1], 1]), F)
    else:
        ps = how[1]
    image = _image()
    got = _sweep(name, ps, image)
    assert got.shape == (F, H, W, 4)
    ref = manifest.reference(spec["reference"])
    comp = compare.Comparison()
    for i, t in enumerate(sweep_ts(F)):
        with _one_thread():
            want = ref(ps, float(t), W, H, image, torch.float32, CPU)
        comp.add(got[i], want)
    ok, checks = compare.judge(comp.numbers(), _cell().settings["limits"])
    assert comp.answers == F
    assert ok, checks


@pytest.mark.parametrize("name", ["ripple", "twirl"])
def test_sweep_equals_render_animation_on_one_device(name):
    ps = draw_call(_spec(name), np.random.default_rng([2**31 + 5, 1]), F)[0]
    image = _image()
    f = mt.compile_source(_spec(name)["source"])
    want = f.render_animation(image, num_frames=F, width=W, height=H, params=ps, device="cpu")
    assert torch.equal(_sweep(name, ps, image), want)


def _records(render):
    before = trace.snapshot()
    render()
    d = trace.since(before)
    return d["spans"], d["counters"]


@pytest.mark.parametrize("name", ["ripple", "twirl"])
def test_a_sweeps_records(name):
    spans, counters = _records(lambda: _sweep(name, {}, _image()))
    assert spans["mm.frame"]["count"] == F and spans["mm.frame"]["parents"] == {"mm.call": F}
    assert spans["mm.shard.tile"]["count"] == 4 * F
    assert spans["mm.shard.tile"]["parents"] == {"mm.frame": 4 * F}
    assert spans["mm.shard.assemble"]["count"] == F
    assert spans["mm.shard.assemble"]["parents"] == {"mm.frame": F}
    assert spans["mm.shard.replicate"]["count"] == 1
    assert spans["mm.evaluate"]["parents"] == {"mm.shard.tile": 4 * F}
    assert counters["shard.tiles"] == 4 * F
    assert counters.get("shard.peer_bytes", 0) == 0
    assert counters["render.pixels"] == F * W * H


def test_a_tiled_render_assembles_once_and_a_render_records_no_shard():
    pond = mt.compile_file("filters/Distorts/pond.mm")
    spans, _ = _records(lambda: pond.render_tiled(_image(), halo=(8, 8), mesh=_mesh(),
                                                  params={"amplitude": 1.0}))
    assert spans["mm.shard.assemble"]["count"] == 1
    for name in ("ripple", "twirl"):
        f = mt.compile_source(_spec(name)["source"])
        spans, counters = _records(lambda: f.render(_image(), device="cpu"))
        assert not [s for s in spans if s.startswith("mm.shard.")]
        assert not [c for c in counters if c.startswith("shard.")]


def test_a_copy_to_another_device_counts_its_bytes():
    a = torch.zeros((6, 10, 4), dtype=torch.float32)
    before = trace.counter("shard.peer_bytes")
    assert peer_copy(a, CPU) is a
    assert trace.counter("shard.peer_bytes") == before
    moved = peer_copy(a, torch.device("meta"))
    assert moved.device.type == "meta"
    assert trace.counter("shard.peer_bytes") == before + 6 * 10 * 4 * 4
