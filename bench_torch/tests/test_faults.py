"""A run with the timed path broken underneath comes out not correct: the
harness's look for a GPU is skipped (the CPU), the rest of the run is the
benchmark's. Faults: an answer altered where it is produced (the image
shifted by one pixel), and half of a batch left out (its jobs' outputs
taken from the other half)."""

import time

import pytest
import torch

import mathmap_tpu_torch.api as api
import mathmap_tpu_torch.serve as serve
from bench_torch.tests import _cells
from bench_torch.harness.cell import run

SIZE = {"width": 96, "height": 54}
CLOSED = {**SIZE, "pool": 12, "sample_per_filter": 1, "jobs": 4}
OPEN = {**SIZE, "rate_per_s": 30.0, "lead_s": 1.0, "grace_s": 20.0, "sample": 12}


def _shifted(method):
    def broken(self, *a, **k):
        return method(self, *a, **k).roll(1, dims=-2)
    return broken


def _half_batch(method):
    def broken(self, *a, **k):
        out = method(self, *a, **k)
        n = out.shape[0]
        if n > 1:
            out[n // 2:] = out[:n - n // 2]
        return out
    return broken


def _run(cell_name, over):
    cell = _cells.find(cell_name)
    over = {k: v for k, v in over.items() if k in cell.traffic or k in ("width", "height")}
    line, checks = run(cell, 2**32 + 11, 1.5, False, torch.device("cpu"), time.perf_counter(),
                       over)
    return line["correct"], checks


CASES = [
    ("distort.frames_4k", CLOSED, "render", _shifted),
    ("distort.frames_1080p", CLOSED, "render", _shifted),
    ("generative.batch_4k", CLOSED, "render_batch", _shifted),
    ("generative.batch_4k", CLOSED, "render_batch", _half_batch),
    ("distort.service_1080p", OPEN, "render", _shifted),
    ("distort.service_1080p", OPEN, "render_batch", _half_batch),
]


@pytest.mark.parametrize("cell_name,over,method,fault", CASES,
                         ids=[f"{c}-{f.__name__}-{m}" for c, _, m, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell_name, over, method, fault):
    if cell_name.startswith("distort.service") and method == "render_batch":
        # a long gathering window, so the dispatcher groups requests
        init = serve.RenderService.__init__

        def grouping(self, *a, **k):
            init(self, *a, **{**k, "window_ms": 300.0})
        monkeypatch.setattr(serve.RenderService, "__init__", grouping)
    monkeypatch.setattr(api.Filter, method, fault(getattr(api.Filter, method)))
    correct, checks = _run(cell_name, over)
    assert correct is False, checks


def test_the_unbroken_path_is_correct():
    assert _run("generative.batch_4k", CLOSED)[0] is True
