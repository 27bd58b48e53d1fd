"""The cell `ripple_anim_1080p` at test sizes on the CPU, as
test_sharded_cell.py holds its cell: the driver sweeps 6 frames of 96x54
through `Filter.render_animation` at the configuration's 2x2 grid
supersampling, small enough that a window of a few seconds holds the calls
each test needs on a loaded machine. The program passes the limits, and
the bfloat16 control and a sweep of one sample a pixel fail them; the
render layer's two readers read 4.0 in a traced run, and nothing where
the program keeps no such counters; the configuration's `reduced` is its
BENCHMARK.json entry's."""

import time
from dataclasses import replace

import pytest
import torch

import mathmap_tpu_torch.api as api
from bench_torch.harness import compare, manifest, program
from bench_torch.harness.cell import make_driver, run
from mathmap_tpu_torch.utils import trace

CELL = "ripple_anim_1080p"
SMALL = {"width": 96, "height": 54, "frames": 6, "pool": 8, "sample_calls_per_filter": 1}
READERS = ("render.samples_per_pixel", "render.walks_per_frame")


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny frames on one thread: several test processes share the machine's
    cores, and torch's own threads would slow each call past the window."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("control,seed", [(True, 2**31 + 91), (False, 2**31 + 92)],
                         ids=["control_fails", "program_passes"])
def test_control_fails_and_program_passes(control, seed):
    cell = _cell()
    drv = make_driver(cell, seed, torch.device("cpu"), SMALL)
    try:
        drv.setup()
        drv.window(3.0)
        drv.release()
        comp = compare.Comparison()
        drv.compare(comp, control=control)
    finally:
        drv.close()
    ok, checks = compare.judge(comp.numbers(), cell.settings["limits"])
    assert comp.answers == 6  # one call of each filter, three frames each
    assert ok is not control, checks


def _one_sample(method):
    def broken(self, *a, options=None, **k):
        return method(self, *a, options=replace(options, supersample=1), **k)
    return broken


def test_a_sweep_of_one_sample_a_pixel_is_not_correct(monkeypatch):
    monkeypatch.setattr(api.Filter, "render_animation",
                        _one_sample(api.Filter.render_animation))
    line, checks = run(_cell(), 2**32 + 19, 1.0, False, torch.device("cpu"),
                       time.perf_counter(), SMALL)
    assert line["correct"] is False, checks
    assert checks["worst_abs"]["value"] > 100 * checks["worst_abs"]["limit"], checks


def test_a_traced_run_reads_four_samples_and_four_walks(monkeypatch):
    """Every frame of every call walks the body at its four subsamples."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    line, checks = run(_cell(), 2**33 + 23, 3.0, True, torch.device("cpu"),
                       time.perf_counter(), {**SMALL, "trace_skip": 1, "trace_calls": 2})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    assert m["render.samples_per_pixel"] == 4.0
    assert m["render.walks_per_frame"] == 4.0


def _snapshot(counters):
    return {"spans": {}, "traced": {}, "counters": counters}


def test_reader_values(monkeypatch):
    monkeypatch.setattr(program, "_snapshot", lambda: (
        _snapshot({"render.pixels": 1000, "render.samples": 4500}), trace))
    r = {"frames": 12, "calls": 2, "slice_counters": {"render.walks": 30}}
    assert manifest.metric_reader(READERS[0]).read(r) == pytest.approx(4.5)
    assert manifest.metric_reader(READERS[1]).read(r) == pytest.approx(2.5)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_counters(monkeypatch, name):
    monkeypatch.setattr(program, "_snapshot",
                        lambda: (_snapshot({"render.pixels": 1000}), trace))
    r = {"frames": 12, "calls": 2, "slice_counters": {"render.pixels": 1000}}
    assert manifest.metric_reader(name).read(r) is None
    monkeypatch.setattr(program, "_trace", lambda: None)
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(name).read({**r, "slice_counters": None}) is None


def test_the_configs_reduced_is_its_entrys():
    bench = manifest.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == _cell().entry["config"])
    assert entry["reduced"] == _cell().config["reduced"] == []
    assert _cell().config["options"]["supersample"] == 2
    assert _cell().config["options"]["supersample_scheme"] == "grid"
