"""The readers of the program's own spans and counters, on synthetic
readings and on a traced closed-loop run on the CPU: what they read, and
nothing where the program keeps no spans."""

import time

import pytest
import torch

from bench_torch.harness import manifest, program
from bench_torch.harness.cell import run
from mathmap_tpu_torch.utils import trace

READERS = ("render.host_ms_per_frame", "render.evaluate_ms_per_frame",
           "render.sync_wait_ms_per_frame", "render.syncs_per_frame.literal",
           "render.syncs_per_frame.param", "render.syncs_per_frame.loop", "setup.kernels_s")


def _span(count, total_ns, self_ns=None):
    return {"count": count, "total_ns": total_ns,
            "self_ns": total_ns if self_ns is None else self_ns, "parents": {}}


def _snapshot():
    """Ten calls with no profiler (two nvcc builds inside them), two under
    one."""
    untraced = {
        "mm.call": _span(10, 758_000_000),
        "mm.build": _span(2, 750_000_000),
        "mm.evaluate": _span(10, 6_000_000, 2_500_000),
        "mm.sync.literal": _span(60, 2_000_000),
        "mm.sync.param": _span(17, 1_000_000),
        "mm.sync.loop": _span(5, 500_000),
    }
    traced = {"mm.call": _span(2, 4_000_000), "mm.sync.literal": _span(12, 1_000_000),
              "mm.sync.param": _span(3, 100_000), "mm.sync.loop": _span(1, 90_000)}
    spans = {name: dict(s) for name, s in untraced.items()}
    for name, s in traced.items():
        for k in ("count", "total_ns", "self_ns"):
            spans[name][k] += s[k]
    return {"spans": spans, "traced": traced, "counters": {"launch.sample_image": 12}}


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(), trace))
    # two traced calls of two jobs each: the untraced calls' 10 are 20 frames
    return {"frames": 4, "calls": 2}


@pytest.mark.parametrize("name,want", [
    ("render.host_ms_per_frame", 0.4),
    ("render.evaluate_ms_per_frame", 0.125),
    ("render.sync_wait_ms_per_frame", 0.175),
    ("render.syncs_per_frame.literal", 3.0),
    ("render.syncs_per_frame.param", 0.75),
    ("render.syncs_per_frame.loop", 0.25),
    ("setup.kernels_s", 0.75),
])
def test_reader_values(synthetic, name, want):
    assert manifest.metric_reader(name).read(synthetic) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_program_spans(monkeypatch, name):
    monkeypatch.setattr(program, "_trace", lambda: None)
    assert manifest.metric_reader(name).read({"frames": 20, "calls": 20}) is None


def test_a_cause_that_did_not_run_reads_zero(monkeypatch, synthetic):
    snap = _snapshot()
    del snap["spans"]["mm.sync.loop"], snap["traced"]["mm.sync.loop"]
    monkeypatch.setattr(program, "_snapshot", lambda: (snap, trace))
    assert manifest.metric_reader("render.syncs_per_frame.loop").read(synthetic) == 0.0


def test_spans_recorded_under_the_profiler_are_left_out():
    from torch.profiler import ProfilerActivity, profile

    before = trace.snapshot()
    with trace.span("mm.test.bench"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("mm.test.bench"):
                pass
    d = trace.since(before)
    assert d["spans"]["mm.test.bench"]["count"] == 3
    assert d["traced"]["mm.test.bench"]["count"] == 2
    assert trace.untraced(d)["mm.test.bench"]["count"] == 1


@pytest.fixture
def this_test_only(monkeypatch):
    """The readers read what the program recorded in this test alone, as a
    run's process holds one run."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))


def _traced(cell_name, over):
    cell = manifest.find_cell(manifest.load_benchmark(), cell_name)
    return run(cell, 2**33 + 17, 0.6, True, torch.device("cpu"), time.perf_counter(),
               {"width": 48, "height": 27, "pool": 9, "sample_per_filter": 1, **over})[0]


def test_closed_loop_reads_the_untraced_calls(this_test_only):
    line = _traced("distort.frames_1080p", {"trace_skip": 3, "trace_calls": 3})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # fisheye, twirl and pond in turn: 5, 7 and 6 literals, 1, 1 and 3 params
    assert m["render.syncs_per_frame.literal"] == pytest.approx(6.0)
    assert m["render.syncs_per_frame.param"] == pytest.approx(5 / 3)
    assert "render.syncs_per_frame.loop" not in m  # not a metric of this cell
    assert m["render.host_ms_per_frame"] > m["render.evaluate_ms_per_frame"] > 0
    assert m["render.sync_wait_ms_per_frame"] > 0
    assert m["setup.kernels_s"] == 0.0  # nothing built on the CPU
    assert m["render.syncs_per_frame"] == pytest.approx(0.0)  # no CUDA trace here


def test_closed_loop_batch_counts_each_job(this_test_only):
    line = _traced("generative.batch_4k", {"jobs": 2, "trace_skip": 2, "trace_calls": 2})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # mandelbrot 20 + 5 and moire 11 + 2 a job, the loop on B3's route
    assert m["render.syncs_per_frame.literal"] == pytest.approx(15.5)
    assert m["render.syncs_per_frame.param"] == pytest.approx(3.5)
    assert m["render.syncs_per_frame.loop"] == 0.0


def test_a_program_without_spans_gives_no_new_metric(monkeypatch):
    monkeypatch.setattr(program, "_trace", lambda: None)
    line = _traced("distort.frames_1080p", {"trace_skip": 3, "trace_calls": 3})
    assert not set(READERS) & set(line["metrics"])
    assert "render.syncs_per_frame" in line["metrics"]
