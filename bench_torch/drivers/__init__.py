"""Traffic drivers: each reads a traffic mix's parameters (traffic/*.json)
and drives the program with them.

A driver module holds `Driver(cell, seed, device, mt, traffic)` with:

- `setup()`: inputs from the seed, filters compiled, every shape the
  traffic uses warmed;
- `window(seconds, profiler)` -> `Window`: the measured window (with
  `profiler`, a `harness.trace.Profiler`, around the part it traces);
- `release()`: frees the program's state, keeping the sampled answers;
- `close()`: stops whatever the driver started (servers, processes,
  temporary files), after `release` or in its place;
- `compare(comparison, control=False)`: each sampled answer against the
  plain reference (with `control`, the reference in bfloat16 in the
  program's place);
- `readings(window, summary)` -> the dict the per-layer metric readers
  read.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Window:
    attempted: int
    failed: int
    #: the window's start, a time.perf_counter() reading
    start: float
    seconds: float
    #: end-to-end values by metric name (setup_s is the harness's)
    values: dict
    #: timings in ms by name, every call or request, for the medians line
    timings: dict = field(default_factory=dict)
    #: anything else the readings need
    extra: dict = field(default_factory=dict)
