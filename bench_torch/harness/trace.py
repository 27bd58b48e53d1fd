"""The traced window: torch.profiler around it, and its reduction to the
device's busy time, its idle gaps, counts and kernel times.

Times are microseconds on the profiler's clock. The window is the span of
the `bench.window` range that `Profiler.start` opens on the host; device
activity is every kernel, copy and memset; an idle gap is a stretch of the
window with none, named after the innermost host operation that spans its
middle (on any thread).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW_MARK = "bench.window"
#: where a window that starts after its profiler opens begins
OPEN_MARK = "bench.open"
CALL_MARK = "bench.call"
SYNC = "cudaStreamSynchronize"
#: host events of the profiler itself
PROFILER_OWN = ("Activity Buffer",)
TOP = 10


@dataclass
class Event:
    name: str
    start: float
    end: float


def union(intervals, lo: float, hi: float) -> list:
    """Merged (start, end) intervals clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def gaps(merged: list, lo: float, hi: float) -> list:
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _innermost(host: list, points: list) -> list:
    """For each point (sorted ascending), the name of the host event with
    the latest start among those that contain it, or 'host: no op'."""
    host = sorted(host, key=lambda e: e.start)
    names, active, k = [], [], 0
    for p in points:
        while k < len(host) and host[k].start <= p:
            active.append(host[k])
            k += 1
        active = [e for e in active if e.end >= p]
        names.append(max(active, key=lambda e: e.start).name if active else "host: no op")
    return names


def _top(totals: dict) -> list:
    return [[name, us / 1e6] for name, us in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


@dataclass
class TraceSummary:
    window_us: float
    busy_us: float
    kernels: int
    syncs: int
    device_ops: list            # [[name, seconds]] by total time
    idle_gaps: list             # [[host op, seconds]] by total idle time
    device: list = field(default_factory=list)   # the window's device events

    def kernel(self, fragment: str) -> tuple:
        """(launches, device microseconds) of kernels whose name holds
        `fragment`."""
        hits = [e for e in self.device if fragment in e.name]
        return len(hits), sum(e.end - e.start for e in hits)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def reduce_trace(device: list, host: list, lo: float, hi: float) -> TraceSummary:
    inside = [e for e in device if e.end > lo and e.start < hi]
    merged = union([(e.start, e.end) for e in inside], lo, hi)
    busy = sum(e - s for s, e in merged)
    ops: dict = {}
    for e in inside:
        ops[e.name] = ops.get(e.name, 0.0) + min(e.end, hi) - max(e.start, lo)
    idle = gaps(merged, lo, hi)
    mids = [(s + e) / 2 for s, e in idle]
    by_host: dict = {}
    for (s, e), name in zip(idle, _innermost(host, mids)):
        by_host[name] = by_host.get(name, 0.0) + (e - s)
    kernels = sum(not is_copy(e.name) for e in inside)
    syncs = sum(e.name == SYNC and lo <= e.start <= hi for e in host)
    return TraceSummary(hi - lo, busy, kernels, syncs, _top(ops), _top(by_host), inside)


def events_of(prof) -> tuple:
    """(device events, host events) of a finished torch.profiler run. A
    host range's copy on the device's timeline (a user annotation) is no
    device work, and the profiler's own buffer requests are no host work
    of the run: both are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        ev = Event(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench."):
                device.append(ev)
        elif not e.name.startswith(PROFILER_OWN):
            host.append(ev)
    return device, host


class Profiler:
    """torch.profiler over one window of the run, with the `bench.window`
    range marking it on the host."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.prof = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once in set-up: its first start
        initialises the device's tracing, which takes seconds."""
        prof = self._profile()
        prof.start()
        torch.zeros(1, device=self.dev).add_(1)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof.stop()

    def start(self):
        from torch.profiler import record_function

        self.prof = self._profile()
        self.prof.start()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()

    def open_now(self):
        """Mark the window's start later than `start`: the summary counts
        from here."""
        from torch.profiler import record_function

        with record_function(OPEN_MARK):
            pass

    def stop(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._mark.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> TraceSummary:
        device, host = events_of(self.prof)
        marks = [e for e in host if e.name == WINDOW_MARK]
        if not marks:
            raise RuntimeError("the trace holds no window mark")
        lo, hi = marks[0].start, marks[0].end
        opens = [e.start for e in host if e.name == OPEN_MARK]
        if opens:
            lo = max(lo, opens[0])
        marks_only = (WINDOW_MARK, OPEN_MARK)
        return reduce_trace(device, [e for e in host if e.name not in marks_only], lo, hi)


def call_mark(traced: bool):
    """A `bench.call` range around one call in a traced window."""
    import contextlib

    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(CALL_MARK)
