"""Rates over the whole window, percentiles over every call, and the
closed loop's accounting of failed calls."""

import time

import numpy as np
import pytest
import torch

from bench_torch.harness import manifest, stats
from bench_torch.harness.cell import make_driver


def test_percentile_matches_numpy():
    rng = np.random.default_rng(3)
    xs = rng.random(257).tolist()
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def _closed(monkeypatch, fail_every=0, delay=0.002):
    cell = manifest.find_cell(manifest.load_benchmark(), "distort.frames_4k")
    drv = make_driver(cell, 7, torch.device("cpu"),
                      {"width": 32, "height": 18, "pool": 12, "sample_per_filter": 1})
    drv.setup()
    calls = {"n": 0}
    real = drv.call

    def call(i):
        calls["n"] += 1
        time.sleep(delay)
        if fail_every and calls["n"] % fail_every == 0:
            raise RuntimeError("planted failure")
        return real(i)

    monkeypatch.setattr(drv, "call", call)
    return drv


def test_rate_is_over_the_whole_window(monkeypatch):
    drv = _closed(monkeypatch)
    win = drv.window(0.3)
    pixels = win.attempted * 32 * 18
    assert win.seconds >= 0.3
    assert win.values["mpix_per_s"] == pytest.approx(pixels / 1e6 / win.seconds)
    assert len(win.timings["call_ms"]) == win.attempted
    assert win.values["call_p95_ms"] == pytest.approx(stats.percentile(win.timings["call_ms"], 95))
    assert min(win.timings["call_ms"]) >= 2.0


def test_a_failed_call_counts_and_stays_in_the_percentile(monkeypatch):
    drv = _closed(monkeypatch, fail_every=2)
    win = drv.window(0.3)
    assert win.failed == win.attempted // 2
    lat = win.timings["call_ms"]
    assert len(lat) == win.attempted
    assert sum(v == 0.3 * 1e3 for v in lat) == win.failed
    assert win.values["call_p95_ms"] == pytest.approx(300.0)
    assert win.values["mpix_per_s"] == pytest.approx(
        (win.attempted - win.failed) * 32 * 18 / 1e6 / win.seconds)
