"""The cell `distort.sharded_4chip` at test sizes on the CPU, as
test_noise_cell.py holds its cell: the driver sweeps 4 frames of 64x32
over a (1,4,1) mesh of "cpu" entries, small enough that a window of a
few seconds holds the calls each test needs on a loaded machine. The
bfloat16 control fails the limits and the program passes them; an answer
shifted by one pixel comes out not correct; the parallel layer's two
readers read the program's records, and nothing where it keeps none; a
traced run reads the layer's spans and counters and the per-frame syncs
of ripple and twirl in turn."""

import time

import pytest
import torch

import mathmap_tpu_torch.api as api
from bench_torch.harness import compare, manifest, program
from bench_torch.harness.cell import make_driver, run
from bench_torch.tests.test_faults import _shifted
from mathmap_tpu_torch.utils import trace

CELL = "distort.sharded_4chip"
SMALL = {"width": 64, "height": 32, "frames": 4, "pool": 8, "sample_calls_per_filter": 1}
READERS = ("shard.assemble_ms_per_frame", "shard.peer_mb_per_frame")


def _cell():
    return manifest.find_cell(manifest.load_benchmark(), CELL)


@pytest.mark.parametrize("control,seed", [(True, 2**31 + 77), (False, 2**31 + 78)],
                         ids=["control_fails", "program_passes"])
def test_control_fails_and_program_passes(control, seed):
    cell = _cell()
    drv = make_driver(cell, seed, torch.device("cpu"), SMALL)
    try:
        drv.setup()
        drv.window(2.0)
        drv.release()
        comp = compare.Comparison()
        drv.compare(comp, control=control)
    finally:
        drv.close()
    ok, checks = compare.judge(comp.numbers(), cell.settings["limits"])
    assert comp.answers == 6  # one call of each filter, three frames each
    assert ok is not control, checks


def test_an_answer_shifted_by_one_pixel_is_not_correct(monkeypatch):
    monkeypatch.setattr(api.Filter, "render_sharded", _shifted(api.Filter.render_sharded))
    line, checks = run(_cell(), 2**32 + 11, 1.0, False, torch.device("cpu"),
                       time.perf_counter(), SMALL)
    assert line["correct"] is False, checks


def _span(count, total_ns):
    return {"count": count, "total_ns": total_ns, "self_ns": total_ns, "parents": {}}


def _snapshot(shard: bool):
    """Ten untraced calls and two traced ones, of 8 frames each."""
    untraced = {"mm.call": _span(10, 900_000_000)}
    traced = {"mm.call": _span(2, 200_000_000)}
    if shard:
        untraced["mm.shard.assemble"] = _span(80, 40_000_000)
        traced["mm.shard.assemble"] = _span(16, 9_000_000)
    spans = {name: dict(s) for name, s in untraced.items()}
    for name, s in traced.items():
        for k in ("count", "total_ns", "self_ns"):
            spans[name][k] += s[k]
    return {"spans": spans, "traced": traced, "counters": {}}


def test_reader_values(monkeypatch):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(True), trace))
    r = {"frames": 16, "calls": 2,
         "slice_counters": {"shard.tiles": 64, "shard.peer_bytes": 48_000_000}}
    # 40 ms over the untraced calls' 80 frames; 48 MB over the slice's 16
    assert manifest.metric_reader(READERS[0]).read(r) == pytest.approx(0.5)
    assert manifest.metric_reader(READERS[1]).read(r) == pytest.approx(3.0)
    r["slice_counters"] = {"shard.tiles": 64}
    assert manifest.metric_reader(READERS[1]).read(r) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_parallel_records(monkeypatch, name):
    monkeypatch.setattr(program, "_snapshot", lambda: (_snapshot(False), trace))
    r = {"frames": 16, "calls": 2, "slice_counters": {"render.pixels": 10}}
    assert manifest.metric_reader(name).read(r) is None
    monkeypatch.setattr(program, "_trace", lambda: None)
    monkeypatch.setattr(program, "_snapshot", lambda: None)
    assert manifest.metric_reader(name).read({**r, "slice_counters": None}) is None


def test_a_traced_run_reads_the_parallel_layer(monkeypatch):
    """Ripple and twirl in turn over four tiles: 8 and 4 param syncs a
    frame, 4 and 0 of `t`; one assembly a frame and no byte between
    devices on a mesh of one device."""
    before = trace.snapshot()
    monkeypatch.setattr(program, "_snapshot", lambda: (trace.since(before), trace))
    line, checks = run(_cell(), 2**33 + 17, 4.0, True, torch.device("cpu"),
                       time.perf_counter(), {**SMALL, "trace_skip": 1, "trace_calls": 2})
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"], checks
    assert m["shard.peer_mb_per_frame"] == 0.0
    assert m["shard.assemble_ms_per_frame"] > 0
    assert m["render.syncs_per_frame.param"] == pytest.approx(6.0)
    assert m["render.syncs_per_frame.literal"] == pytest.approx(2.0)
    assert m["render.host_ms_per_frame"] > m["shard.assemble_ms_per_frame"]
