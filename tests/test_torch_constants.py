"""The per-device cache of constants (mathmap_tpu_torch/utils/constants.py)
on the CPU, which runs the same code as a card: a value is kept once per
(type and bits, dtype, device) and read back as the same tensor, equal bit
for bit to a fresh upload; nothing is kept under torch.export; renders of
every route write into no kept tensor; the cache does not grow with the
frames; a render from an empty cache equals one from a full cache bit for
bit; and a hit counts `literal.cached` where a miss is a `mm.sync.literal`
span."""

import math
import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.generators.artifact import export_artifact
from mathmap_tpu_torch.utils import constants, trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H = 64, 48
#: the filters of the benchmark's cells: (folder, name, params of a frame)
FILTERS = {
    "turbulence": ("Noise", {"scale": 80.0, "gain": 0.5}),
    "voronoi": ("Render", {"cell": 90.0}),
    "fisheye": ("Distorts", {}),
    "twirl": ("Distorts", {}),
    "pond": ("Distorts", {}),
    "mandelbrot": ("Render", {}),
    "moire": ("Render", {}),
}
SYNC = trace.span("mm.sync.literal")


@pytest.fixture(autouse=True)
def empty_cache():
    constants.clear()
    yield
    constants.clear()


def _filter(name):
    folder = FILTERS[name][0]
    return mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))


def _inputs(f, seed=3):
    img = np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)
    return [torch.from_numpy(img)] * len(f.image_params)


def _render(name, **kw):
    f = _filter(name)
    return f.render(*_inputs(f), width=W, height=H, device="cpu", **kw)


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}[t.dtype])


def _literals(delta) -> tuple:
    """(misses, hits) in a trace.since() delta."""
    return (delta["spans"].get("mm.sync.literal", {}).get("count", 0),
            delta["counters"].get("literal.cached", 0))


# -- keys and values --------------------------------------------------------------

@pytest.mark.parametrize("value", [0.0, -0.0, 1.0, 0.08, 0.7131, 1e9, 17.3, math.pi, 3, True,
                                   float("inf"), float("nan")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_hit_returns_the_kept_tensor_equal_to_a_fresh_upload(value, dtype):
    first = constants.constant(SYNC, value, dtype, torch.device("cpu"))
    again = constants.constant(SYNC, value, dtype, torch.device("cpu"))
    fresh = torch.tensor(value, dtype=dtype)
    assert again is first and type(first) is torch.Tensor
    assert first.dtype == dtype and first.shape == ()
    assert torch.equal(_bits(first), _bits(fresh))
    assert len(constants.entries()) == 1


def _nan(payload: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", 0x7FF8000000000000 | payload))[0]


@pytest.mark.parametrize("a,b", [
    ((0.0, torch.float32, "cpu"), (-0.0, torch.float32, "cpu")),
    ((_nan(0), torch.float32, "cpu"), (_nan(1 << 40), torch.float32, "cpu")),
    ((1, torch.float32, "cpu"), (1.0, torch.float32, "cpu")),
    ((16777217, torch.float32, "cpu"), (16777217.0, torch.float32, "cpu")),
    ((1, torch.float32, "cpu"), (True, torch.float32, "cpu")),
    ((0.1, torch.float32, "cpu"), (0.1, torch.float64, "cpu")),
    ((0.5, torch.float32, "cpu"), (0.5, torch.float32, "meta")),
], ids=["signed zeros", "nan bits", "int float", "int float rounding", "int bool",
        "dtype", "device"])
def test_each_difference_of_the_key_is_an_entry_of_its_own(a, b):
    got = [constants.constant(SYNC, v, dt, torch.device(d)) for v, dt, d in (a, b)]
    assert got[0] is not got[1]
    assert len(constants.entries()) == 2
    for (v, dt, d), t in zip((a, b), got):
        assert t.device == torch.device(d)
        assert constants.constant(SYNC, v, dt, torch.device(d)) is t
        if d == "cpu":
            assert torch.equal(_bits(t), _bits(torch.tensor(v, dtype=dt)))
    assert math.copysign(1.0, float(constants.constant(SYNC, -0.0, torch.float32,
                                                       torch.device("cpu")))) == -1.0


def test_a_miss_is_a_sync_span_and_a_hit_a_counter():
    before = trace.snapshot()
    constants.constant(SYNC, 17.3, torch.float32, torch.device("cpu"))
    assert _literals(trace.since(before)) == (1, 0)
    before = trace.snapshot()
    for _ in range(3):
        constants.constant(SYNC, 17.3, torch.float32, torch.device("cpu"))
    assert _literals(trace.since(before)) == (0, 3)


def test_a_fake_tensor_is_never_kept():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        got = constants.constant(SYNC, 2.5, torch.float32, torch.device("cpu"))
    assert type(got) is not torch.Tensor
    assert constants.entries() == {}


def test_a_full_cache_is_emptied_and_refills(monkeypatch):
    monkeypatch.setattr(constants, "MAX_ENTRIES", 4)
    for v in range(4):
        constants.constant(SYNC, float(v), torch.float32, torch.device("cpu"))
    assert len(constants.entries()) == 4
    constants.constant(SYNC, 4.0, torch.float32, torch.device("cpu"))
    assert len(constants.entries()) == 1


def test_threads_share_one_tensor_a_value():
    """More threads than cores look up the same values with a short switch
    interval: every thread gets the one kept tensor of each value."""
    values = [0.25 * k for k in range(16)]
    seen = [[] for _ in range(2 * (os.cpu_count() or 1) + 2)]

    def look(out):
        for _ in range(50):
            out.append([constants.constant(SYNC, v, torch.float32, torch.device("cpu"))
                        for v in values])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=look, args=(out,)) for out in seen]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    kept = constants.entries()
    assert len(kept) == len(values)
    final = [constants.constant(SYNC, v, torch.float32, torch.device("cpu")) for v in values]
    for out in seen:
        assert len(out) == 50
        for row in out[1:]:
            assert all(a is b for a, b in zip(row, final))


# -- renders ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FILTERS))
def test_a_render_from_an_empty_cache_equals_one_from_a_full_cache(name):
    params = FILTERS[name][1]
    first = _render(name, t=0.3, params=params)
    assert constants.entries()
    second = _render(name, t=0.3, params=params)
    assert torch.equal(_bits(first), _bits(second))


#: (misses, hits) of a 64x48 frame with the cache emptied, and of the same
#: Filter's next frame: voronoi's first frame uses 340 constants, 11
#: distinct, its next 200, its loops' probes answered by their memos
#: (runtime/loops.py::probe_outcome); mandelbrot's loop likewise; turbulence
#: uses 13, its `t` a miss every frame, and the Perlin table once a process
COUNTS = {
    "voronoi": ((11, 329), (0, 200)),
    "turbulence": ((7, 6), (1, 12)),
    "fisheye": ((4, 1), (0, 5)),
    "twirl": ((6, 1), (0, 7)),
    "pond": ((5, 1), (0, 6)),
    "mandelbrot": ((7, 13), (0, 18)),
    "moire": ((6, 5), (1, 10)),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_misses_and_hits_of_a_first_and_a_second_frame(name):
    params = FILTERS[name][1]
    _render("turbulence", t=0.1)  # the Perlin table, kept apart, on the device
    constants.clear()
    f = _filter(name)
    got = []
    for t in (0.3, 0.4):
        before = trace.snapshot()
        f.render(*_inputs(f), width=W, height=H, device="cpu", t=t, params=params)
        got.append(_literals(trace.since(before)))
    assert tuple(got) == COUNTS[name]


def test_the_cache_does_not_grow_with_frames_params_and_t():
    rs = np.random.RandomState(7)
    sizes = []
    for k in range(20):
        _render("turbulence", t=float(rs.rand()),
                params={"scale": float(rs.uniform(60, 100)), "gain": float(rs.uniform(0.4, 0.6))})
        _render("voronoi", t=float(rs.rand()), params={"cell": float(rs.uniform(70, 110))})
        _render("moire", t=float(rs.rand()))
        sizes.append(len(constants.entries()))
    assert sizes[0] > 0 and set(sizes) == {sizes[0]}


def _routes(name):
    """Render `name` through frames, batch, tiled, region and corners."""
    f = _filter(name)
    ins = _inputs(f)
    params = FILTERS[name][1]
    f.render_frames(*ins, num_frames=2, width=W, height=H, params=params, device="cpu")
    f.render_batch(*[torch.stack([i, i]) for i in ins], ts=[0.2, 0.6], width=W, height=H,
                   params=params, device="cpu")
    f.render_tiled(*ins, mesh=mt.make_mesh(2, 1, 1, devices=["cpu"] * 2), width=W, height=H,
                   params=params, t=0.5)
    f.render(*ins, width=W, height=H, params=params, device="cpu",
             options=mt.RenderOptions(region=(8, 4, 24, 20)))
    f.render(*ins, width=W, height=H, params=params, device="cpu",
             options=mt.RenderOptions(supersample=2, supersample_scheme="corners"))


def test_no_render_writes_into_a_kept_tensor():
    """Every filter of the cells through every route: each kept tensor is
    unwritten (`_version` 0) and still its key's value."""
    for name in sorted(FILTERS):
        _routes(name)
    kept = constants.entries()
    assert len(kept) >= 10
    for (kind, bits, dtype, device), t in kept.items():
        value = bits if issubclass(kind, int) else struct.unpack("<d", bits)[0]
        assert t._version == 0
        assert t.dtype == dtype and t.device == device
        assert torch.equal(_bits(t), _bits(torch.tensor(kind(value), dtype=dtype)))


@pytest.mark.parametrize("name", ["turbulence", "voronoi"])
def test_an_export_keeps_nothing_and_a_live_render_after_it_is_right(name, tmp_path):
    """A torch.export trace makes the tracer's tensors: none is kept, and a
    live render after the export equals the one before, a real tensor."""
    params = FILTERS[name][1]
    before = _render(name, t=0.3, params=params)
    constants.clear()
    export_artifact(_filter(name), str(tmp_path / f"{name}.mmxa"), 32, 24, params=params,
                    device="cpu")
    assert constants.entries() == {}
    after = _render(name, t=0.3, params=params)
    assert type(after) is torch.Tensor
    assert torch.equal(_bits(after), _bits(before))
    assert all(type(t) is torch.Tensor for t in constants.entries().values())
