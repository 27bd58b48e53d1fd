"""The port's one record of where a render's host time goes: spans and
counters kept in memory per process, and the CLI's `--stats` line.

- `span(name)`: a context manager that records, per name, its count, its
  total host time, its self time (the total less the time of the spans
  opened inside it) and the spans it ran inside. Spans nest through a
  per-thread stack; a span object keeps nothing of one entry, so the hot
  path builds each once (`_EVALUATE = span("mm.evaluate")`) and enters it
  in every thread. While a torch profiler records, a span is also a
  `record_function` range, on the same clock as the device's events, and
  its records are kept apart as well (`snapshot()["traced"]`): the
  profiler lengthens what it records. A `mm.sync.*` span opens no range:
  the trace names its wait by the op that waits. With no profiler running
  a span costs one flag check more than its bookkeeping. While torch
  compiles or exports a program a span does nothing, so an exported graph
  is the same with or without it.
- `count(name, n=1)`: an integer counter (kernel launches, nvcc builds).
- `snapshot()`: every span's and counter's totals as a plain dict, the one
  reader for the benchmark, the CLI's `--stats` and the service's `/stats`.

Each thread records into a table of its own, so the frame path takes no
lock; `snapshot()` merges the tables. The table of a thread that has ended
is folded into one kept for all of them, so a server that starts a thread
a request keeps as many tables as it has threads alive.

The spans of the render path, outermost first: `mm.call` (one public
render entry), `mm.frame` (one job of an entry that renders several:
`render_batch`, `render_animation`, `render_frames`; a `Filter.render`'s
one frame is its call) and `mm.evaluate` (one walk of the filter body,
the coordinate grids and the default params included); beside them
`mm.compile`, `mm.build` (a kernel library loaded, or built by nvcc),
`mm.png.decode`, `mm.png.encode`, `mm.image.read`, `mm.image.write`,
`mm.serve.wait` and `mm.serve.dispatch`. Every place where the host waits
on the device is a span `mm.sync.<cause>` (`literal`, `param`, `loop`,
`readback`, `stage`): its count is the number of waits, its time the time
the host sat blocked. The counters: `launch.<kernel>` for each CUDA kernel
launch, `build.nvcc` for each nvcc run. A span costs about a microsecond
of host time, so the render path has none finer than these: the params'
conversion, the grids and the channel stack show in a trace by their
torch ops.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _autograd_profiler
# torch.compiler.is_compiling() returns the module's `_is_compiling_flag`
# (after ruling out TorchScript, which runs no span); a span reads the flag
# and saves the two calls
import torch.compiler as _compiler

#: the span names whose time is the host waiting on the device start so
SYNC_PREFIX = "mm.sync."

_local = threading.local()


class _Table:
    """One thread's records: spans by (name, the enclosing span's name or
    None), [count, total ns, self ns], those recorded while a profiler ran
    apart, and counters by name."""

    __slots__ = ("spans", "traced", "counters", "stack")

    def __init__(self):
        self.spans: dict = {}
        self.traced: dict = {}
        self.counters: dict = {}
        #: the open spans, innermost last: [span, child ns, traced, range, start ns]
        self.stack: list = []

    def merge(self, other: "_Table") -> None:
        """Add another table's records to this one's."""
        for mine, theirs in ((self.spans, other.spans), (self.traced, other.traced)):
            for key, rec in dict(theirs).items():
                acc = mine.setdefault(key, [0, 0, 0])
                for i, v in enumerate(list(rec)):
                    acc[i] += v
        for name, v in dict(other.counters).items():
            self.counters[name] = self.counters.get(name, 0) + v


#: (thread, its table) of every live thread that has recorded
_tables: list = []
#: the records of the threads that have ended
_ended = _Table()
_tables_lock = threading.Lock()


def _fold_ended() -> None:
    """Fold the tables of ended threads into _ended (_tables_lock held)."""
    live = []
    for thread, table in _tables:
        if thread.is_alive():
            live.append((thread, table))
        else:
            _ended.merge(table)
    _tables[:] = live


def _table() -> _Table:
    try:
        return _local.table
    except AttributeError:
        table = _local.table = _Table()
        with _tables_lock:
            _fold_ended()
            _tables.append((threading.current_thread(), table))
        return table


class span:
    """`with span("mm.compile"): ...` records the block's host time under the
    name (see the module's docstring); `n` is what it adds to the name's
    count, where one block holds n waits on the device."""

    __slots__ = ("name", "n", "ranged")

    def __init__(self, name: str, n: int = 1):
        self.name = name
        self.n = n
        self.ranged = not name.startswith(SYNC_PREFIX)

    def __enter__(self):
        if _compiler._is_compiling_flag:
            return self
        try:
            stack = _local.table.stack
        except AttributeError:
            stack = _table().stack
        if _autograd_profiler._is_profiler_enabled:
            rng = None
            if self.ranged:
                rng = _autograd_profiler.record_function(self.name)
                rng.__enter__()
            stack.append([self, 0, True, rng, perf_counter_ns()])
        else:
            stack.append([self, 0, False, None, perf_counter_ns()])
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        if _compiler._is_compiling_flag:
            return False
        table = _local.table
        _, child_ns, traced, rng, t0 = table.stack.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        _record(table, self, t1 - t0, child_ns, traced)
        return False

    def tensor(self, value, dtype: torch.dtype, device) -> torch.Tensor:
        """`torch.tensor(value, dtype=dtype, device=device)` recorded as this
        span, without a with-block's cost: the form for the render path's
        most frequent waits, one literal or one param each."""
        if _compiler._is_compiling_flag:
            return torch.tensor(value, dtype=dtype, device=device)
        t0 = perf_counter_ns()
        out = torch.tensor(value, dtype=dtype, device=device)
        ns = perf_counter_ns() - t0
        try:
            table = _local.table
        except AttributeError:
            table = _table()
        _record(table, self, ns, 0, _autograd_profiler._is_profiler_enabled)
        return out


def _record(table: _Table, closed: span, ns: int, child_ns: int, traced: bool) -> None:
    """Add a span that ran `ns`, `child_ns` of them in spans inside it, to
    the thread's table, and its time to the enclosing span's children."""
    stack = table.stack
    if stack:
        parent = stack[-1]
        parent[1] += ns
        key = (closed.name, parent[0].name)
    else:
        key = (closed.name, None)
    records = table.traced if traced else table.spans
    rec = records.get(key)
    if rec is None:
        rec = records[key] = [0, 0, 0]
    rec[0] += closed.n
    rec[1] += ns
    rec[2] += ns - child_ns


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (nothing while torch compiles)."""
    if _compiler._is_compiling_flag:
        return
    try:
        counters = _local.table.counters
    except AttributeError:
        counters = _table().counters
    counters[name] = counters.get(name, 0) + n


def _by_name(records: dict) -> dict:
    spans: dict = {}
    for (name, parent), (n, ns, self_ns) in records.items():
        s = spans.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0, "parents": {}})
        s["count"] += n
        s["total_ns"] += ns
        s["self_ns"] += self_ns
        s["parents"][parent] = s["parents"].get(parent, 0) + n
    return spans


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_ns", "self_ns", "parents":
    {parent or None: count}}}, "traced": the part of "spans" recorded
    while a profiler ran, in the same form, "counters": {name: value}},
    summed over every thread of the process."""
    total = _Table()
    with _tables_lock:
        _fold_ended()
        # merge() copies each dict in one step of the interpreter: a thread
        # recording meanwhile cannot change it halfway
        for table in [_ended] + [t for _, t in _tables]:
            total.merge(table)
    everything = dict(total.spans)
    for key, rec in total.traced.items():
        acc = everything[key] = list(everything.get(key, (0, 0, 0)))
        for i, v in enumerate(rec):
            acc[i] += v
    return {"spans": _by_name(everything), "traced": _by_name(total.traced),
            "counters": total.counters}


def _spans_since(before: dict, after: dict) -> dict:
    spans = {}
    for name, s in after.items():
        b = before.get(name, {})
        n = s["count"] - b.get("count", 0)
        if n:
            parents = {p: k - b.get("parents", {}).get(p, 0) for p, k in s["parents"].items()}
            spans[name] = {"count": n,
                           "total_ns": s["total_ns"] - b.get("total_ns", 0),
                           "self_ns": s["self_ns"] - b.get("self_ns", 0),
                           "parents": {p: k for p, k in parents.items() if k}}
    return spans


def since(before: dict, after: dict | None = None) -> dict:
    """What was recorded between two snapshots (`after` defaults to now),
    in snapshot()'s form; spans that did not run in between are left out."""
    after = snapshot() if after is None else after
    counters = {name: v - before["counters"].get(name, 0)
                for name, v in after["counters"].items()}
    return {"spans": _spans_since(before["spans"], after["spans"]),
            "traced": _spans_since(before["traced"], after["traced"]),
            "counters": {k: v for k, v in counters.items() if v}}


def untraced(snap: dict) -> dict:
    """A snapshot's spans less those recorded while a profiler ran: what
    they cost with no profiler, in snapshot()'s "spans" form."""
    return _spans_since(snap["traced"], snap["spans"])


def total_s(snap: dict, name: str) -> float:
    """A span's total seconds in a snapshot (0.0 where it did not run)."""
    return snap["spans"].get(name, {}).get("total_ns", 0) / 1e9


def counter(name: str) -> int:
    """The counter's value now, over every thread."""
    return snapshot()["counters"].get(name, 0)


@dataclass
class RenderStats:
    """The CLI's --stats line: the canvas, the frames rendered, and each
    phase's seconds. `render_s` runs from the first render to a device
    sync after the last frame, with no image I/O in it; `phases` holds the
    rest (decode, encode, write), read from the spans."""

    width: int = 0
    height: int = 0
    frames: int = 0
    parse_s: float = 0.0
    render_s: float = 0.0
    phases: dict = field(default_factory=dict)

    @property
    def mpix_per_s(self) -> float:
        total = self.frames * self.width * self.height
        return total / self.render_s / 1e6 if self.render_s else 0.0

    def to_json(self) -> str:
        return json.dumps({
            "width": self.width, "height": self.height, "frames": self.frames,
            "parse_s": round(self.parse_s, 4), "render_s": round(self.render_s, 4),
            "mpix_per_s": round(self.mpix_per_s, 2),
            **{k: round(v, 4) for k, v in self.phases.items()},
        })
