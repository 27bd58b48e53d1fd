"""The noise layer's kernel share (`metrics/noise.kernel_share.py`) on the
CPU: what it reads from the program's counters, nothing where the program
keeps no `noise.kernel_points` (a program from before B6), and a traced
run of the cell `noise.frames_4k` at a test size on the CPU, where no
call runs the kernel and the line leaves the share out."""

import time

import pytest
import torch

from bench_torch.harness import manifest, program
from bench_torch.harness.cell import run
from mathmap_tpu_torch.utils import trace

CELL = "noise.frames_4k"
NAME = "noise.kernel_share"
SMALL = {"width": 48, "height": 27, "pool": 8, "sample_per_filter": 1, "trace_skip": 1,
         "trace_calls": 2}


def _snapshot(counters: dict):
    return {"spans": {}, "traced": {}, "counters": counters}


def _read(monkeypatch, counters: dict):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(counters), trace))
    return manifest.metric_reader(NAME).read({"frames": 2, "calls": 2})


@pytest.mark.parametrize("counters,want", [
    ({"noise.points": 216 * 14_400, "noise.kernel_points": 216 * 14_400}, 100.0),
    ({"noise.points": 200, "noise.kernel_points": 150}, 75.0),
    ({"noise.points": 200, "noise.kernel_points": 0}, 0.0),
])
def test_reader_values(monkeypatch, counters, want):
    assert _read(monkeypatch, counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"noise.points": 200, "render.pixels": 100},
                                      {"render.pixels": 100}, {}])
def test_reader_reads_nothing_without_the_kernels_counters(monkeypatch, counters):
    assert _read(monkeypatch, counters) is None
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(NAME).read({"frames": 2, "calls": 2}) is None


def test_a_traced_run_on_the_cpu_reads_no_kernel_share(monkeypatch):
    """Every noise call of a CPU run evaluates the plain version: the line
    has the cell's other noise metrics and leaves the share out. On one CPU
    thread: torch's CPU sqrt, which the voronoi reference calls, can return
    wrong values on its first multi-threaded call in a process (ROADMAP
    C5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    cell = manifest.find_cell(manifest.load_benchmark(), CELL)
    try:
        line, checks = run(cell, 2**33 + 29, 2.0, True, torch.device("cpu"),
                           time.perf_counter(), SMALL)
    finally:
        torch.set_num_threads(threads)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    assert NAME not in m
    assert m["noise.points_per_pixel"] > 4
