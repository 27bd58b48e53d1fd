"""The cell `noise.frames_4k` at test sizes on the CPU, as test_control.py,
test_faults.py and test_program_spans.py hold the other cells: the
bfloat16 control fails its limits and the program passes them; an answer
shifted by one pixel comes out not correct; the noise layer's two readers
read the program's records, and nothing where it keeps none."""

import time

import pytest
import torch

import mathmap_tpu_torch.api as api
from bench_torch.harness import compare, manifest, program
from bench_torch.harness.cell import make_driver, run
from bench_torch.tests.test_faults import _shifted
from mathmap_tpu_torch.utils import trace

CELL = "noise.frames_4k"
SMALL = {"width": 160, "height": 90, "pool": 8, "sample_per_filter": 1}
READERS = ("noise.host_ms_per_frame", "noise.points_per_pixel")


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


@pytest.mark.parametrize("control,seed", [(True, 2**31 + 77), (False, 2**31 + 78)],
                         ids=["control_fails", "program_passes"])
def test_control_fails_and_program_passes(control, seed):
    cell = _cell()
    drv = make_driver(cell, seed, torch.device("cpu"), SMALL)
    try:
        drv.setup()
        drv.window(1.0)
        drv.release()
        comp = compare.Comparison()
        drv.compare(comp, control=control)
    finally:
        drv.close()
    ok, checks = compare.judge(comp.numbers(), cell.settings["limits"])
    assert comp.answers == 2  # one of each filter
    assert ok is not control, checks


def test_an_answer_shifted_by_one_pixel_is_not_correct(monkeypatch):
    monkeypatch.setattr(api.Filter, "render", _shifted(api.Filter.render))
    line, checks = run(_cell(), 2**32 + 11, 1.0, False, torch.device("cpu"),
                       time.perf_counter(), {**SMALL, "width": 96, "height": 54})
    assert line["correct"] is False, checks


def _span(count, total_ns):
    return {"count": count, "total_ns": total_ns, "self_ns": total_ns, "parents": {}}


def _snapshot(noise: bool):
    """Ten untraced calls and two traced ones, of 14,400 pixels each."""
    untraced = {"mm.call": _span(10, 900_000_000), "mm.evaluate": _span(10, 800_000_000)}
    traced = {"mm.call": _span(2, 200_000_000)}
    counters = {"render.pixels": 12 * 14_400}
    if noise:
        untraced["mm.noise"] = _span(180, 300_000_000)
        traced["mm.noise"] = _span(36, 90_000_000)
        counters["noise.points"] = 216 * 14_400
    spans = {name: dict(s) for name, s in untraced.items()}
    for name, s in traced.items():
        for k in ("count", "total_ns", "self_ns"):
            spans[name][k] += s[k]
    return {"spans": spans, "traced": traced, "counters": counters}


@pytest.mark.parametrize("name,want", [("noise.host_ms_per_frame", 30.0),
                                       ("noise.points_per_pixel", 18.0)])
def test_reader_values(monkeypatch, name, want):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(True), trace))
    # two traced calls of one frame: the untraced calls' 10 are 10 frames
    assert manifest.metric_reader(name).read({"frames": 2, "calls": 2}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_noise_records(monkeypatch, name):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(False), trace))
    assert manifest.metric_reader(name).read({"frames": 2, "calls": 2}) is None
    monkeypatch.setattr(program, "_trace", lambda: None)
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(name).read({"frames": 2, "calls": 2}) is None


def test_a_traced_run_reads_the_noise_layer(monkeypatch):
    """Turbulence and voronoi in turn: 4 and 32 noise calls a frame, 18 a
    pixel where the process rendered as many frames of each."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    line, checks = run(_cell(), 2**33 + 17, 2.0, True, torch.device("cpu"),
                       time.perf_counter(),
                       {**SMALL, "width": 48, "height": 27, "trace_skip": 1, "trace_calls": 2})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    # the warm-up's two calls of each filter, then the window's in turn
    n_turbulence = 2 + (line["attempted"] + 1) // 2
    n_voronoi = 2 + line["attempted"] // 2
    want = (4 * n_turbulence + 32 * n_voronoi) / (n_turbulence + n_voronoi)
    assert m["noise.points_per_pixel"] == pytest.approx(want)
    assert m["noise.host_ms_per_frame"] > 0
    assert m["render.host_ms_per_frame"] > m["noise.host_ms_per_frame"]
