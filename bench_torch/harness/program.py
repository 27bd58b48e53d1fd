"""The program's own spans and counters (mathmap_tpu_torch/utils/trace.py),
read when a traced run's per-layer metrics are, in the run's process.

The program keeps what it records while a profiler runs apart. The times
are those of every call the process made with no profiler recording: the
set-up's warm-up and the window's untraced calls, whose frames are the
`mm.call` spans' count times the frames of one traced call. The counts are
those of the profiled slice, the calls whose device trace the other
metrics read: a count does not change under the profiler. Every function
returns None where the program keeps no spans, as a program from before
the registry gives."""

from __future__ import annotations

import importlib.util


def _trace():
    """The program's trace module, or None where it has none."""
    if importlib.util.find_spec("mathmap_tpu_torch.utils.trace") is None:
        return None
    from mathmap_tpu_torch.utils import trace

    return trace


def _snapshot():
    """(the program's snapshot now, its trace module), or None."""
    trace = _trace()
    return None if trace is None else (trace.snapshot(), trace)


def untraced(r: dict):
    """(the spans recorded with no profiler, by name, and their frames), or
    None."""
    got = _snapshot()
    if got is None or not r.get("calls"):
        return None
    snap, trace = got
    spans = trace.untraced(snap)
    calls = spans.get("mm.call", {}).get("count", 0)
    if not calls:
        return None
    return spans, calls * r["frames"] / r["calls"]


def _total(spans: dict, name: str, field: str = "total_ns") -> int:
    return spans.get(name, {}).get(field, 0)


def host_ms_per_frame(r: dict):
    """The `mm.call` spans' ms, less the kernels' builds inside them (which
    fall in the warm-up), over the frames."""
    got = untraced(r)
    if got is None:
        return None
    spans, frames = got
    return (_total(spans, "mm.call") - _total(spans, "mm.build")) / 1e6 / frames


def span_ms_per_frame(r: dict, name: str, field: str = "total_ns"):
    """A span's total (or self) ms over the frames."""
    got = untraced(r)
    if got is None:
        return None
    spans, frames = got
    return _total(spans, name, field) / 1e6 / frames


def sync_ms_per_frame(r: dict):
    """The summed ms of every mm.sync.* span over the frames."""
    got = untraced(r)
    if got is None:
        return None
    spans, frames = got
    prefix = _trace().SYNC_PREFIX
    return sum(s["total_ns"] for name, s in spans.items()
               if name.startswith(prefix)) / 1e6 / frames


def syncs_per_frame(r: dict, cause: str):
    """The count of mm.sync.<cause> spans in the profiled slice over its
    frames."""
    got = _snapshot()
    if got is None or not r.get("frames"):
        return None
    snap, trace = got
    return snap["traced"].get(trace.SYNC_PREFIX + cause, {}).get("count", 0) / r["frames"]


def build_s(r: dict):
    """The seconds of every `mm.build` span of the process, profiled or not:
    the kernels' libraries loaded or built, all in set-up, where the
    warm-up runs every shape of the window."""
    got = _snapshot()
    if got is None:
        return None
    snap, _ = got
    return _total(snap["spans"], "mm.build") / 1e9
