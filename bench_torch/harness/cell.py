"""One run of one cell: set-up, the window, the comparison, the line.

`run` drives a cell's traffic driver on `device` and returns the result
line and the checks. The device is the GPU in every run of the benchmark;
the CPU only in the harness's own tests, whose lines say `cpu`.
"""

from __future__ import annotations

import gc
import sys

import torch

from bench_torch.harness import compare, device as device_mod, manifest, stats
from bench_torch.harness.result import metric
from bench_torch.harness.trace import Profiler


def make_driver(cell, seed: int, dev: torch.device, overrides: dict | None = None):
    import mathmap_tpu_torch as mt

    traffic = {**cell.traffic, **(overrides or {})}
    return manifest.driver(traffic["driver"]).Driver(cell, seed, dev, mt, traffic)


def timing_lines(window) -> None:
    """Median and 95th percentile of each timing, on standard error."""
    for name, values in window.timings.items():
        if values:
            print(f"timing {name}: n {len(values)} p50 {stats.percentile(values, 50)!r} "
                  f"p95 {stats.percentile(values, 95)!r}", file=sys.stderr)


def per_layer(cell, readings: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device, t_start: float,
        overrides: dict | None = None) -> tuple:
    """-> (line without checks, checks)."""
    drv = make_driver(cell, seed, dev, overrides)
    try:
        drv.setup()
        profiler = None
        if trace:
            profiler = Profiler(dev)
            profiler.warm()
        win = drv.window(seconds, profiler)
        setup_s = win.start - t_start
        device = device_mod.describe(dev, int(cell.entry["chips"]))
        summary = profiler.summary() if trace else None
        drv.release()
        gc.collect()
        comparison = compare.Comparison()
        drv.compare(comparison)
        correct, checks = compare.judge(comparison.numbers(), cell.settings["limits"])
        timing_lines(win)
        if trace:
            metrics = per_layer(cell, drv.readings(win, summary))
            device["busy_s"] = summary.busy_us / 1e6
            device["window_s"] = summary.window_us / 1e6
        else:
            values = {**win.values, "setup_s": setup_s}
            metrics = {m["name"]: metric(values[m["name"]], m["unit"]) for m in cell.end_to_end}
        print(f"window: {win.attempted} attempted, {win.failed} failed, {win.seconds!r} s; "
              f"setup_s {setup_s!r}; compared {comparison.answers} answers", file=sys.stderr)
        line = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
                "metrics": metrics, "device": device}
        if trace:
            line["breakdown"] = {"device_ops": summary.device_ops,
                                 "idle_gaps": summary.idle_gaps}
        return line, checks
    finally:
        drv.close()


def main(argv, t_start: float) -> int:
    import argparse

    from bench_torch.harness import result

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once on the GPU.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.find_cell(manifest.load_benchmark(), args.workload)
    try:
        dev = device_mod.require_cuda(int(cell.entry["chips"]))
    except device_mod.NoDevice as exc:
        print(f"bench_torch: {exc}", file=sys.stderr)
        return 2
    line, checks = run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    result.emit(line, checks)
    return 0

