"""The render layer's hit share of its constant cache
(`metrics/render.literal_hit_share.py`) on the CPU: what it reads from the
program's counter and spans, nothing where the program keeps no
`literal.cached` (a program from before the cache), and a traced run of
the cell `distort.frames_1080p` at a test size on the CPU, where every
constant after the warm-up is a hit."""

import time

import pytest
import torch

from bench_torch.harness import manifest, program
from bench_torch.harness.cell import run
from mathmap_tpu_torch.utils import trace

NAME = "render.literal_hit_share"


def _snapshot(counters: dict, literal_syncs: int):
    spans = {"mm.sync.literal": {"count": literal_syncs, "total_ns": 1000 * literal_syncs,
                                 "self_ns": 1000 * literal_syncs, "parents": {}}}
    return {"spans": spans, "traced": {}, "counters": counters}


def _read(monkeypatch, counters: dict, literal_syncs: int):
    monkeypatch.setattr(program, "_snapshot",
                        lambda: (_snapshot(counters, literal_syncs), trace))
    return manifest.metric_reader(NAME).read({"frames": 2, "calls": 2})


@pytest.mark.parametrize("counters,syncs,want", [
    ({"literal.cached": 352}, 1, 100.0 * 352 / 353),
    ({"literal.cached": 30}, 1, 100.0 * 30 / 31),
    ({"literal.cached": 900}, 0, 100.0),
    ({"literal.cached": 0}, 40, 0.0),
])
def test_reader_values(monkeypatch, counters, syncs, want):
    assert _read(monkeypatch, counters, syncs) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"render.pixels": 100}, {}])
def test_reader_reads_nothing_without_the_caches_counter(monkeypatch, counters):
    assert _read(monkeypatch, counters, 176) is None
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(NAME).read({"frames": 2, "calls": 2}) is None


def test_a_traced_run_on_the_cpu_reads_the_hit_share(monkeypatch):
    """The distortion filters use only constants: past the warm-up's
    misses, every use is a hit."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    cell = manifest.find_cell(manifest.load_benchmark(), "distort.frames_1080p")
    line, checks = run(cell, 2**33 + 31, 0.6, True, torch.device("cpu"), time.perf_counter(),
                       {"width": 48, "height": 27, "pool": 9, "sample_per_filter": 1,
                        "trace_skip": 3, "trace_calls": 3})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    assert 90.0 < m[NAME] <= 100.0
    assert m["render.syncs_per_frame.literal"] == 0.0
