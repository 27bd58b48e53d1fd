"""The run's last line: its keys, the checks last, the compared numbers as
the last lines of standard error; and a run without a GPU prints nothing."""

import io
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_torch.harness import manifest, result
from bench_torch.harness.cell import run


def test_last_line_keys_and_checks_last():
    cell = manifest.find_cell(manifest.load_benchmark(), "distort.frames_4k")
    line, checks = run(cell, 2**33 + 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
                       {"width": 48, "height": 27, "pool": 9, "sample_per_filter": 1})
    out, err = io.StringIO(), io.StringIO()
    result.emit(line, checks, out, err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    assert set(last["metrics"]) == {"mpix_per_s", "call_p95_ms", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.getvalue().strip().splitlines()
    assert len(tail) == len(checks)
    for name, c in checks.items():
        assert any(ln.startswith(f"check {name}: {c['value']!r} limit {c['limit']!r}")
                   for ln in tail)


def test_traced_line_has_busy_window_and_breakdown():
    cell = manifest.find_cell(manifest.load_benchmark(), "distort.frames_1080p")
    line, _ = run(cell, 9, 0.5, True, torch.device("cpu"), time.perf_counter(),
                  {"width": 48, "height": 27, "pool": 9, "sample_per_filter": 1,
                   "trace_skip": 1, "trace_calls": 3})
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                           "distort.frames_1080p", "--seed", "1", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_no_gpu_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for machines without one")
    out = _run_py(manifest.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
