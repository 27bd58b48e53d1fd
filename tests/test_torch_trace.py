"""The port's spans and counters (mathmap_tpu_torch/utils/trace.py): a span
is a profiler range only while a profiler records, nests with self time,
does nothing while torch exports; every place a render waits on the device
is a `mm.sync.<cause>` span, whose counts by cause are pinned here per
filter; counts from many threads add up; the CLI's --stats and the
service's /stats read the same record. All on the CPU: a count is the same
on every device, and on a card each is a cudaStreamSynchronize."""

import glob
import json
import os
import sys
import threading
import time
import traceback
import types
import urllib.request

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.cli import main
from mathmap_tpu_torch.generators.artifact import _export
from mathmap_tpu_torch.imgio.images import write_image
from mathmap_tpu_torch.utils import trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H = 64, 48
CAUSES = ("literal", "param", "loop", "readback", "stage")


def _filter(folder, name):
    return mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))


def _image():
    return torch.from_numpy(np.random.RandomState(3).rand(H, W, 4).astype(np.float32))


def _syncs(delta) -> dict:
    return {c: delta["spans"].get(f"mm.sync.{c}", {}).get("count", 0) for c in CAUSES}


def _render_counts(f, *inputs, **kw) -> dict:
    before = trace.snapshot()
    f.render(*inputs, width=W, height=H, device="cpu", **kw)
    return _syncs(trace.since(before))


# -- the registry ---------------------------------------------------------------

def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(trace._autograd_profiler, "record_function", refuse)
    with trace.span("mm.test.outer"):
        with trace.span("mm.test.inner"):
            pass
    _filter("Distorts", "twirl").render(_image(), width=W, height=H, device="cpu")
    assert trace.snapshot()["spans"]["mm.test.inner"]["parents"] == {"mm.test.outer": 1}


def test_self_time_excludes_the_child_spans():
    before = trace.snapshot()
    with trace.span("mm.test.parent"):
        time.sleep(0.002)
        for _ in range(2):
            with trace.span("mm.test.child"):
                time.sleep(0.003)
    d = trace.since(before)["spans"]
    parent, child = d["mm.test.parent"], d["mm.test.child"]
    assert child["count"] == 2 and child["parents"] == {"mm.test.parent": 2}
    assert parent["self_ns"] == parent["total_ns"] - child["total_ns"]
    assert child["total_ns"] >= 6e6 and parent["self_ns"] >= 2e6
    assert child["self_ns"] == child["total_ns"]


def test_a_wait_in_tensor_form_is_a_child_of_the_open_span():
    before = trace.snapshot()
    wait = trace.span("mm.sync.test")
    with trace.span("mm.test.holder"):
        wait.tensor(1.5, torch.float32, "cpu")
        wait.tensor(2.5, torch.float32, "cpu")
    d = trace.since(before)["spans"]
    holder, waits = d["mm.test.holder"], d["mm.sync.test"]
    assert waits["count"] == 2 and waits["parents"] == {"mm.test.holder": 2}
    assert holder["self_ns"] == holder["total_ns"] - waits["total_ns"]


def test_counts_from_eight_threads_are_all_kept():
    """Eight threads record while snapshots are taken, switching every
    microsecond: every count is kept, and the tables of the threads that
    ended are folded into one."""
    before = trace.snapshot()
    start = threading.Barrier(9)

    def work():
        start.wait()
        for _ in range(5000):
            trace.count("test.threads")
            with trace.span("mm.test.threads"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        start.wait()
        while any(t.is_alive() for t in threads):
            trace.snapshot()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    d = trace.since(before)
    assert d["counters"]["test.threads"] == 40000
    assert d["spans"]["mm.test.threads"]["count"] == 40000
    assert not any(thread in threads for thread, _ in trace._tables)


def test_render_spans_are_profiler_ranges_nested_as_the_render_is():
    from torch.profiler import ProfilerActivity, profile

    f = _filter("Distorts", "pond")
    img = _image()
    f.render(img, width=W, height=H, device="cpu")  # first-call costs out of the trace

    def ranges_of(render):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            render()
        ranges = {}
        for e in prof.events():
            if e.name.startswith("mm."):
                ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
        return ranges

    def inside(ranges, child, parent):
        return all(any(ps <= s and e <= pe for ps, pe in ranges[parent])
                   for s, e in ranges[child])

    # one frame: its call holds its evaluation; the waits open no range
    one = ranges_of(lambda: f.render(img, width=W, height=H, device="cpu"))
    assert set(one) == {"mm.call", "mm.evaluate"}
    assert len(one["mm.call"]) == len(one["mm.evaluate"]) == 1
    assert inside(one, "mm.evaluate", "mm.call")
    # a batch: a frame a job inside the call, an evaluation inside each
    batch = ranges_of(lambda: f.render_batch(mt.shared(img), ts=[0.1, 0.4], width=W,
                                             height=H, device="cpu"))
    assert set(batch) == {"mm.call", "mm.frame", "mm.evaluate"}
    assert (len(batch["mm.call"]), len(batch["mm.frame"]), len(batch["mm.evaluate"])) == (1, 2, 2)
    assert inside(batch, "mm.frame", "mm.call") and inside(batch, "mm.evaluate", "mm.frame")


def test_spans_and_counts_do_nothing_while_torch_exports():
    class Probe(torch.nn.Module):
        def forward(self, x):
            with trace.span("mm.test.exported"):
                trace.count("test.exported")
                return x + 1

    torch.export.export(Probe(), (torch.zeros(3),), strict=False)
    snap = trace.snapshot()
    assert "mm.test.exported" not in snap["spans"]
    assert "test.exported" not in snap["counters"]


def _graph(f, opts, params):
    program, _ = _export(f, 24, 20, opts, torch.device("cpu"), params)
    return [str(n.target) for n in program.graph.nodes]


@pytest.mark.parametrize("folder,name,params", [
    ("Distorts", "twirl", {"angle": 2.0}),
    ("Render", "mandelbrot", {"zoom": 1.5}),
])
def test_an_exported_graph_is_the_same_with_spans_under_a_profiler(monkeypatch, folder, name,
                                                                     params):
    """Exported inside a running profiler, where each live span would be a
    record_function range, the graph has the node count of an export with
    the registry switched off."""
    from torch.profiler import ProfilerActivity, profile

    f = _filter(folder, name)
    opts = mt.RenderOptions()
    with profile(activities=[ProfilerActivity.CPU]):
        live = _graph(f, opts, params)
    monkeypatch.setattr(trace, "_compiler", types.SimpleNamespace(_is_compiling_flag=True))
    off = _graph(f, opts, params)
    assert len(live) == len(off) and live == off
    assert not any("record_function" in t for t in live)


# -- syncs by cause -------------------------------------------------------------

#: (literal, param, loop, readback, stage) syncs of one 64x48 render on the
#: CPU route, an input image passed as a host tensor
PINNED = {
    ("Distorts", "fisheye"): (5, 1, 0, 0, 1),
    ("Distorts", "twirl"): (7, 1, 0, 0, 1),
    ("Distorts", "pond"): (6, 3, 0, 0, 1),
    ("Render", "mandelbrot"): (20, 5, 0, 0, 0),
    ("Render", "moire"): (11, 2, 0, 0, 0),
}


@pytest.mark.parametrize("folder,name", sorted(PINNED))
def test_sync_counts_by_cause_are_pinned(folder, name):
    f = _filter(folder, name)
    ins = [_image()] * len(f.image_params)
    assert tuple(_render_counts(f, *ins).values()) == PINNED[folder, name]


@pytest.mark.parametrize("folder,name", sorted(PINNED))
def test_a_batch_of_n_jobs_syncs_n_times_one_job(folder, name):
    f = _filter(folder, name)
    one = PINNED[folder, name]
    ins = [mt.shared(_image())] * len(f.image_params)
    before = trace.snapshot()
    f.render_batch(*ins, ts=[0.1, 0.4, 0.7], width=W, height=H, device="cpu")
    got = _syncs(trace.since(before))
    # the shared input is staged once for the batch
    assert tuple(got.values()) == tuple(3 * n for n in one[:4]) + (one[4],)


def test_the_eager_loop_counts_its_mask_readbacks():
    """mandelbrot's loop off the kernel route: the masked eager loop reads
    its mask on the host once per while_unroll steps."""
    f = _filter("Render", "mandelbrot")
    counts = _render_counts(f, options=mt.RenderOptions(pallas_while="off"))
    assert counts == {"literal": 148, "param": 5, "loop": 17, "readback": 0, "stage": 0}


def test_a_host_input_is_one_stage_sync():
    f = _filter("Distorts", "twirl")
    assert _render_counts(f, np.asarray(_image()))["stage"] == 1
    assert _render_counts(f, _image())["stage"] == 1


def test_the_tiled_halo_check_is_a_readback():
    f = _filter("Distorts", "pond")
    mesh = mt.make_mesh(1, 2, 1, devices=["cpu"] * 2)
    before = trace.snapshot()
    f.render_tiled(_image(), halo=(8, 8), mesh=mesh, params={"amplitude": 1.0})
    d = trace.since(before)
    assert _syncs(d)["readback"] == 1
    assert d["spans"]["mm.call"]["count"] == 1


PLAIN_VERSIONS = ("sample_image_reference", "sample_tiled_reference", "_while_loop_cpu",
                  "run_program", "_fold_const")


def _device_target(args, kwargs):
    if kwargs.get("device") is not None:
        return kwargs["device"]
    return next((a for a in args[1:] if isinstance(a, (str, torch.device))), None)


class _HostDeviceTraffic(TorchFunctionMode):
    """Every copy to a device and every read of a tensor's value on the
    host, outside the kernels' plain versions (which stand for kernels that
    read nothing back), with the innermost open span at that moment."""

    def __init__(self):
        super().__init__()
        self.outside = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        moves = (
            (func in (torch.tensor, torch.as_tensor) and kwargs.get("device") is not None)
            or (func is torch.Tensor.to and _device_target(args, kwargs) is not None
                and args[0].device.type == "cpu")
            or func in (torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.cpu,
                        torch.Tensor.tolist))
        if moves:
            stack = trace._table().stack
            frames = traceback.extract_stack()[:-1]
            # a sync span's with-block is open, or its tensor() form called this
            if not ((stack and stack[-1][0].name.startswith(trace.SYNC_PREFIX))
                    or (frames[-1].name == "tensor"
                        and frames[-1].filename.endswith(os.path.join("utils", "trace.py")))):
                if not any(fr.name in PLAIN_VERSIONS for fr in frames):
                    at = [fr for fr in frames if "mathmap_tpu_torch" in fr.filename]
                    self.outside.append(f"{func.__name__} at {at[-1] if at else '?'}")
        return func(*args, **kwargs)


FILTERS = sorted(os.path.relpath(p, os.path.join(ROOT, "filters"))
                 for p in glob.glob(os.path.join(ROOT, "filters", "**", "*.mm"), recursive=True))


@pytest.mark.parametrize("rel", FILTERS)
def test_every_wait_of_a_render_is_a_sync_span(rel):
    """Each filter of the library, rendered from a host array: every copy
    to the device and every host read lies inside a `mm.sync.*` span."""
    try:
        f = mt.compile_file(os.path.join(ROOT, "filters", rel))
    except mt.MMError:
        pytest.skip("not a standalone filter")
    img = np.random.RandomState(1).rand(24, 32, 4).astype(np.float32)
    mode = _HostDeviceTraffic()
    with mode:
        try:
            f.render(*[img] * len(f.image_params), width=32, height=24, device="cpu")
        except mt.MMError:
            pass  # a filter that needs params it was not given: what ran is checked
    assert mode.outside == []


# -- the front ends ---------------------------------------------------------------

def test_cli_stats_reads_its_phases_from_the_spans(tmp_path, capsys):
    src = tmp_path / "in.png"
    write_image(str(src), np.random.RandomState(2).rand(20, 24, 4).astype(np.float32))
    out = tmp_path / "out.png"
    assert main(["filters/Distorts/twirl.mm", str(src), str(out), "--stats", "--interpret"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"decode_s", "encode_s", "write_s", "render_s", "parse_s"} <= set(stats)
    assert stats["frames"] == 1 and stats["render_s"] > 0
    assert stats["decode_s"] > 0 and stats["encode_s"] > 0 and stats["write_s"] >= 0


def test_http_stats_holds_the_trace_snapshot():
    from http.server import ThreadingHTTPServer

    from mathmap_tpu_torch.expression_db import ExpressionDB
    from mathmap_tpu_torch.serve import RenderService, make_handler

    service = RenderService(db=ExpressionDB(root=""), device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        service.render_sync({"source": "filter red () rgbaColor(1, 0, 0, 1) end"}, [], 8, 6)
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/stats") as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        service.shutdown()
    assert "dispatches" in body
    spans = body["trace"]["spans"]
    assert spans["mm.serve.wait"]["count"] >= 1 and spans["mm.serve.dispatch"]["count"] >= 1
    assert "mm.serve.dispatch" in spans["mm.call"]["parents"]
