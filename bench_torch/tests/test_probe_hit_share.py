"""The noise layer's hit share of the loops' probe memos
(`metrics/noise.probe_hit_share.py`) on the CPU: what it reads from the
program's counter and spans, nothing where the program keeps no
`probe.cached` (a program from before the memo), and traced runs of the
cells `noise.frames_4k` and `generative.batch_4k` at test sizes on the
CPU, where every probe after the warm-up's first frame of a filter is a
hit."""

import time

import pytest
import torch

from bench_torch.harness import manifest, program
from bench_torch.harness.cell import run
from mathmap_tpu_torch.utils import trace

NAME = "noise.probe_hit_share"


def _snapshot(counters: dict, probes: int):
    spans = {"mm.loop.probe": {"count": probes, "total_ns": 1000 * probes,
                               "self_ns": 1000 * probes, "parents": {}}}
    return {"spans": spans, "traced": {}, "counters": counters}


def _read(monkeypatch, counters: dict, probes: int):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(counters, probes), trace))
    return manifest.metric_reader(NAME).read({"frames": 2, "calls": 2})


@pytest.mark.parametrize("counters,probes,want", [
    ({"probe.cached": 796}, 5, 100.0 * 796 / 801),
    ({"probe.cached": 4}, 5, 100.0 * 4 / 9),
    ({"probe.cached": 900}, 0, 100.0),
    ({"probe.cached": 0}, 40, 0.0),
])
def test_reader_values(monkeypatch, counters, probes, want):
    assert _read(monkeypatch, counters, probes) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"render.pixels": 100}, {}])
def test_reader_reads_nothing_without_the_memos_counter(monkeypatch, counters):
    assert _read(monkeypatch, counters, 15) is None
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(NAME).read({"frames": 2, "calls": 2}) is None


@pytest.mark.parametrize("cell,size", [
    ("noise.frames_4k", {"width": 48, "height": 27, "pool": 8, "sample_per_filter": 1}),
    ("generative.batch_4k", {"width": 48, "height": 27, "jobs": 2, "pool": 9,
                             "sample_per_filter": 1}),
])
def test_a_traced_run_on_the_cpu_reads_the_hit_share(monkeypatch, cell, size):
    """Voronoi's first frame probes 5 times; each later frame finds its 4
    outcomes in the memos. Mandelbrot's first job probes once; each later
    job finds its outcome."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    c = manifest.find_cell(manifest.load_benchmark(), cell)
    line, checks = run(c, 2**33 + 37, 1.0, True, torch.device("cpu"), time.perf_counter(),
                       {**size, "trace_skip": 1, "trace_calls": 2})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    assert 50.0 < m[NAME] < 100.0
