"""The memo of each while loop's probe (runtime/loops.py::probe_outcome) on
the CPU. A probe evaluates the loop's condition and body once to learn
each carried name's length and tag; a loop keeps that outcome under a key
of what it depends on (`probe_key`), and a later frame with the same key
runs no probe:

- one outcome: for every loop of the library entries that hold a `while`
  and of the fuzz programs that do, the outcome the memo hands a warm
  frame equals a full probe run beside it;
- a warm frame equals a cold frame of a freshly compiled filter bit for
  bit (voronoi, mandelbrot, rand_walk, a nest of loops that draw, a
  do-while);
- a constant the probe could read keys apart: a param's default, `W`, a
  static param, -0.0 against 0.0; a passed param and `t` do not;
- the memo is bypassed, and the full probe runs, where the tiled
  renderer's halo check measures samples and under torch.export; a probe
  that raises keeps nothing and raises again on the next frame;
- one memo keeps every loop's outcomes apart and empties at its bound;
- `probe.cached` counts each answered probe, with no `mm.loop.probe`;
- the tiles of a sharded frame share one outcome;
- threads share the memos."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
from mathmap_tpu_torch.lang import astnodes as A
from mathmap_tpu_torch.runtime import loops, tracer
from mathmap_tpu_torch.utils import trace
from mathmap_tpu_torch.utils.errors import MMTypeError
from test_fuzz import ExoticGen, ExprGen

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H = 20, 12

RAND_WALK = ("s = 0; i = 0; while s < 1 && i < 64 do s = s + rand(0, 0.1) * (1 + x / W);"
             " i = i + 1 end; grayColor(i / 64)")
NESTED_RAND = ("s = 0; i = 0; while i < 3 + x * 0 do j = 0;"
               "  while j < i + y * 0 do s = s + rand(0, 1); j = j + 1 end; i = i + 1 end;"
               "grayColor(s / 4)")
DO_WHILE = ("i = 0; s = x; do s = s * 0.5 + rand(0, 0.1); i = i + 1 while i < 3 + x * 0 end;"
            "grayColor(s / 8 + i / 10)")

#: library entries (the .mm files and the .mmc compositions) whose filter
#: holds a `while` (no composition's does)
DB = mt.default_db()
LOOPED = sorted(n for n in DB.entries
                if any(isinstance(s, A.While) for s in A.walk(DB.compile(n).fdef.body)))
#: the fuzz programs of tests/test_torch_fuzz.py that hold a `while`
FUZZ = [(g.__name__, s) for g, seeds in ((ExprGen, range(60)), (ExoticGen, range(600, 630)))
        for s in seeds if "while" in g(s).program()]


def _loops_of(f):
    """The While nodes of every filter the Filter can reach."""
    return [n for d in f.filters.values() for n in A.walk(d.body) if isinstance(n, A.While)]


def _inputs(f, seed=11):
    """An image for each image param, and one for origVal where there is none."""
    n = max(1, sum(p.kind == "image" for p in f.fdef.params))
    return [np.random.RandomState(seed + i).rand(H, W, 4).astype(np.float32) for i in range(n)]


def _bits(t):
    return t.view(torch.int32)


@pytest.fixture
def held(monkeypatch):
    """Every memo lookup inside also runs the full probe and holds the
    outcome to it: {"lookups": keyed lookups, "hits": those the memo held}."""
    real = tracer.probe_outcome
    seen = {"lookups": 0, "hits": 0}

    def spy(node, key, probe):
        if key is not None:
            seen["lookups"] += 1
            seen["hits"] += key in loops.probe_memo(node)
        got = real(node, key, probe)
        assert got == probe()
        return got

    monkeypatch.setattr(tracer, "probe_outcome", spy)
    return seen


def _held_twice(f, seen, **kw):
    """A cold and a warm frame of `f`, each outcome held to a full probe:
    the warm frame finds every key in the memo."""
    ins = _inputs(f)
    f.render(*ins, width=W, height=H, t=0.3, device="cpu", **kw)
    assert seen["lookups"] > 0
    seen.update(lookups=0, hits=0)
    f.render(*ins, width=W, height=H, t=0.7, device="cpu", **kw)
    assert seen["lookups"] > 0 and seen["hits"] == seen["lookups"]


def test_the_library_has_looped_entries_and_fuzz_programs():
    assert len(LOOPED) == 12 and {"mandelbrot", "voronoi", "do_while_demo"} <= set(LOOPED)
    assert len(FUZZ) >= 20


@pytest.mark.parametrize("name", LOOPED)
def test_a_library_loops_memo_holds_a_full_probes_outcome(held, name):
    _held_twice(DB.compile(name), held)


@pytest.mark.parametrize("gen,seed", FUZZ, ids=[f"{g}-{s}" for g, s in FUZZ])
def test_a_fuzz_loops_memo_holds_a_full_probes_outcome(held, gen, seed):
    src = {"ExprGen": ExprGen, "ExoticGen": ExoticGen}[gen](seed).program()
    _held_twice(mt.compile_source(src), held)


BIT_FOR_BIT = {
    "voronoi": lambda: mt.compile_file(os.path.join(ROOT, "filters", "Render", "voronoi.mm")),
    "mandelbrot": lambda: mt.compile_file(os.path.join(ROOT, "filters", "Render",
                                                       "mandelbrot.mm")),
    "rand_walk": lambda: mt.compile_source(RAND_WALK),
    "nested_rand": lambda: mt.compile_source(NESTED_RAND),
    "do_while": lambda: mt.compile_source(DO_WHILE),
}


@pytest.mark.parametrize("name", sorted(BIT_FOR_BIT))
@pytest.mark.parametrize("options", [{}, {"pallas_while": "off"}], ids=["auto", "masked"])
def test_a_warm_frame_equals_a_cold_frame_bit_for_bit(name, options):
    opts = mt.RenderOptions(seed=5, **options)
    f = BIT_FOR_BIT[name]()
    ins = _inputs(f)
    f.render(*ins, width=W, height=H, t=0.2, device="cpu", options=opts)
    before = trace.snapshot()
    warm = f.render(*ins, width=W, height=H, t=0.6, device="cpu", options=opts)
    d = trace.since(before)
    assert d["counters"].get("probe.cached", 0) > 0 and "mm.loop.probe" not in d["spans"]
    cold = BIT_FOR_BIT[name]().render(*ins, width=W, height=H, t=0.6, device="cpu",
                                      options=opts)
    assert torch.equal(_bits(warm), _bits(cold))


#: a loop whose body branches on `k`: its key holds k's constant when k
#: has one
KEYED = ("filter keyed (float k: -1-1 (0.5)) s = 0; i = 0; "
         "while i < 3 do if k > 0.25 then s = s + x else s = s - y * W end; i = i + 1 end; "
         "grayColor(s / 40) end")


def _memo_after(f, renders):
    node, = _loops_of(f)
    for kw in renders:
        f.render(**{"width": W, "height": H, "device": "cpu", **kw})
    return loops.probe_memo(node)


@pytest.mark.parametrize("case,renders,entries", [
    ("default and static param", [{}, {"params": {"k": 0.1},
                                       "options": mt.RenderOptions(static_params=("k",))}], 2),
    ("two static values", [{"params": {"k": v}, "options": mt.RenderOptions(static_params=("k",))}
                           for v in (0.1, 0.9, 0.1)], 2),
    ("-0.0 and 0.0", [{"params": {"k": v}, "options": mt.RenderOptions(static_params=("k",))}
                      for v in (-0.0, 0.0)], 2),
    ("W", [{"width": w} for w in (20, 24, 20)], 2),
    ("passed params and t", [{"params": {"k": v}, "t": t}
                             for v, t in ((0.1, 0.0), (0.9, 0.5), (-0.3, 0.9))], 1),
])
def test_what_the_probe_can_read_keys_apart(held, case, renders, entries):
    f = mt.compile_source(KEYED)
    memo = _memo_after(f, renders)
    assert len(memo) == entries
    assert held["hits"] == held["lookups"] - entries


def test_a_probe_tap_past_the_halo_raises_on_every_frame():
    """The tiled renderer's halo check measures the probe's taps (at loop
    depth 0, as the reference does): with the check on, the memo is
    bypassed, so the second frame's probe raises as the first's did."""
    src = ("s = 0; i = 0; while i < 2 do "
           "s = s + red(origVal(xy + xy:[0, 6])); i = i + 1 end; grayColor(s / 2)")
    f = mt.compile_source(src)
    img = np.random.RandomState(9).rand(16, 32, 4).astype(np.float32)
    mesh = mt.make_mesh(1, 8, 1, devices=["cpu"] * 8)
    for _ in range(2):
        with pytest.raises(mt.MMRuntimeError, match="bounded-displacement"):
            f.render_tiled(img, halo=2, mesh=mesh)
    node, = _loops_of(f)
    assert loops.probe_memo(node) == {}
    # unchecked, the tiles share one outcome
    before = trace.snapshot()
    for _ in range(2):
        f.render_tiled(img, halo=2, mesh=mesh, check=False)
    d = trace.since(before)
    assert len(loops.probe_memo(node)) == 1
    assert d["counters"]["probe.cached"] == 15 and d["spans"]["mm.loop.probe"]["count"] == 1


def test_a_sharded_frames_tiles_share_one_outcome():
    """The four tiles of a sharded voronoi frame read one memo: the first
    tile probes 5 times, the others find the 4 outcomes a tile reads, and
    the next frame probes none; the frame equals a one-device render bit
    for bit."""
    f = BIT_FOR_BIT["voronoi"]()
    mesh = mt.make_mesh(1, 4, 1, devices=["cpu"] * 4)
    got = []
    for t in (0.3, 0.4):
        before = trace.snapshot()
        out = f.render_sharded(width=W, height=16, mesh=mesh, t=t)
        d = trace.since(before)
        got.append((d["spans"].get("mm.loop.probe", {}).get("count", 0),
                    d["counters"].get("probe.cached", 0)))
    assert got == [(5, 12), (0, 16)]
    want = BIT_FOR_BIT["voronoi"]().render(width=W, height=16, t=0.4, device="cpu")
    assert torch.equal(_bits(out), _bits(want))


def test_an_export_keeps_nothing_and_renders_as_before(tmp_path):
    f = BIT_FOR_BIT["voronoi"]()
    export_artifact(f, str(tmp_path / "voronoi.mmxa"), W, H, device="cpu")
    assert all(loops.probe_memo(n) == {} for n in _loops_of(f))
    art = load_artifact(str(tmp_path / "voronoi.mmxa"))
    got = art.render(t=0.4)
    want = BIT_FOR_BIT["voronoi"]().render(width=W, height=H, t=0.4, device="cpu")
    assert torch.equal(_bits(got), _bits(want))


def test_a_raising_probe_keeps_nothing_and_raises_on_every_frame():
    """The body is never reached (the condition is false at entry), so only
    the probe adds tuples of lengths 2 and 3: it raises on every frame."""
    f = mt.compile_source("s = 0; i = 5; while i < 3 do s = s + [1, 2] + [1, 2, 3]; "
                          "i = i + 1 end; grayColor(s)")
    for _ in range(3):
        with pytest.raises(MMTypeError, match="tuple lengths 2 and 3 do not match"):
            f.render(*_inputs(f), width=W, height=H, device="cpu")
    node, = _loops_of(f)
    assert loops.probe_memo(node) == {}


def test_a_memo_empties_at_its_bound(monkeypatch):
    monkeypatch.setattr(loops, "_PROBES", {})
    monkeypatch.setattr(loops, "PROBE_ENTRIES", 5)
    node = A.While()
    outcome = {"s": (1, "nil")}
    for k in range(loops.PROBE_ENTRIES):
        assert loops.probe_outcome(node, (k,), lambda: outcome) is outcome
    assert len(loops.probe_memo(node)) == loops.PROBE_ENTRIES
    loops.probe_outcome(node, ("one more",), lambda: outcome)
    assert list(loops.probe_memo(node)) == [("one more",)]
    # a hit runs no probe
    assert loops.probe_outcome(node, ("one more",), lambda: 1 / 0) is outcome


def test_two_loops_keep_their_outcomes_apart(monkeypatch):
    """One memo holds every loop's outcomes: two loops under one key keep
    their own, and the memo's bound counts both."""
    monkeypatch.setattr(loops, "_PROBES", {})
    monkeypatch.setattr(loops, "PROBE_ENTRIES", 3)
    a, b = A.While(), A.While()
    assert loops.probe_outcome(a, ("k",), lambda: {"s": (1, "nil")}) == {"s": (1, "nil")}
    assert loops.probe_outcome(b, ("k",), lambda: {"s": (2, "xy")}) == {"s": (2, "xy")}
    assert loops.probe_memo(a) == {("k",): {"s": (1, "nil")}}
    assert loops.probe_memo(b) == {("k",): {"s": (2, "xy")}}
    loops.probe_outcome(a, ("j",), lambda: {})
    loops.probe_outcome(b, ("j",), lambda: {})
    assert loops.probe_memo(a) == {} and loops.probe_memo(b) == {("j",): {}}


def test_none_keys_nothing():
    node = A.While()
    calls = []
    for _ in range(2):
        loops.probe_outcome(node, None, lambda: calls.append(1) or {})
    assert calls == [1, 1] and loops.probe_memo(node) == {}


def test_a_warm_voronoi_frame_counts_its_answered_probes():
    """A cold frame probes 5 times: the outer loop, the inner loop inside
    that probe, and the inner loop in each of the 3 outer steps. A warm
    frame finds the outer loop's outcome and the 3 inner ones, 4
    `probe.cached`, and skips the outer probe whole, the inner loop in it
    too: no `mm.loop.probe`."""
    f = BIT_FOR_BIT["voronoi"]()
    got = []
    for t in (0.3, 0.4, 0.5):
        before = trace.snapshot()
        f.render(width=W, height=H, t=t, device="cpu")
        d = trace.since(before)
        got.append((d["spans"].get("mm.loop.probe", {}).get("count", 0),
                    d["counters"].get("probe.cached", 0)))
    assert got == [(5, 0), (0, 4), (0, 4)]


def test_threads_share_the_memos():
    """More threads than cores render one voronoi Filter with a short switch
    interval: every frame equals a lone cold frame bit for bit, and the
    memos end with the 5 outcomes."""
    f = BIT_FOR_BIT["voronoi"]()
    want = BIT_FOR_BIT["voronoi"]().render(width=8, height=6, t=0.5, device="cpu")
    outs = [[] for _ in range(2 * (os.cpu_count() or 1) + 2)]

    def render(out):
        for _ in range(3):
            out.append(f.render(width=8, height=6, t=0.5, device="cpu"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=render, args=(out,)) for out in outs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for out in outs:
        assert len(out) == 3
        assert all(torch.equal(_bits(o), _bits(want)) for o in out)
    assert sorted(len(loops.probe_memo(n)) for n in _loops_of(f)) == [1, 4]
