"""Closed loop of sharded t-sweeps: one `Filter.render_sharded` call at a
time over a (1, chips, 1) mesh, the next sent when every card of the mesh
has finished the last one.

Traffic parameters (traffic/<mix>.json):

- `width`, `height`: the canvas; the input image is made at that size
  from the seed on the mesh's first device once, before the window;
- `frames`: frames a call, a t-sweep at the API's default times (frame i
  at t = i / frames, RenderOptions.periodic);
- `pool`: calls drawn from the seed; the window cycles through them. Call
  i renders the configuration's filter i modulo their number, with its own
  params and the middle frame it samples;
- `sample_calls_per_filter`: calls kept per filter for the comparison, a
  uniform sample of the window's calls drawn from the seed; of each, three
  frames are cloned (the first, the call's middle frame, the last), and
  no whole sweep outlives its call;
- `trace_skip`, `trace_calls`: the calls a traced run profiles.

The mesh puts the cell's `chips` devices on the row axis: cuda:0 to
cuda:{chips - 1} on the card, as many "cpu" entries in the harness's own
tests. Each frame's rows split over them, the input is copied to each,
and the sweep is gathered on the first.

End-to-end values: `mpix_per_s`, the output pixels of every completed
call (frames x W x H) over the window's seconds (from its start to the
end of its last call), and `call_p95_ms`, the 95th percentile of every
call's host time from the call to the synchronize of the mesh's last
card; a failed call counts as the whole window.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from bench_torch.drivers import Window
from bench_torch.harness import images, manifest, params, program, stats
from bench_torch.harness.trace import WINDOW_MARK, call_mark, union


def sweep_ts(frames: int) -> np.ndarray:
    """The t of each frame of a sweep, float32 as the API computes its
    default (periodic) times: frame i of N at i / N."""
    return np.arange(frames, dtype=np.float32) / frames


def draw_call(spec: dict, rng: np.random.Generator, frames: int) -> tuple:
    """(params, the indices of the frames sampled) of one call of the
    filter `spec`, drawn from `rng`: the first frame, one between, the
    last."""
    middle = int(rng.integers(1, frames - 1))
    return params.draw(spec.get("params", {}), rng), (0, middle, frames - 1)


def card_busy(prof) -> dict:
    """{card index: % of the traced window in which a kernel, copy or
    memset ran on it} from a finished torch.profiler run."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e for e in events if e.name == WINDOW_MARK and e.device_type != DeviceType.CUDA]
    if not marks:
        return {}
    lo, hi = float(marks[0].time_range.start), float(marks[0].time_range.end)
    by_card: dict = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("bench.")):
            by_card.setdefault(e.device_index, []).append(
                (float(e.time_range.start), float(e.time_range.end)))
    return {card: 100.0 * sum(e - s for s, e in union(iv, lo, hi)) / (hi - lo)
            for card, iv in sorted(by_card.items())}


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device, mt, traffic: dict):
        self.cell, self.seed, self.dev, self.mt = cell, seed, dev, mt
        self.tr = traffic
        self.w, self.h = int(traffic["width"]), int(traffic["height"])
        self.frames = int(traffic["frames"])
        self.ts = sweep_ts(self.frames)
        self.specs = cell.config["filters"]
        chips = int(cell.entry["chips"])
        if dev.type == "cuda":
            self.devices = [torch.device("cuda", i) for i in range(chips)]
        else:
            self.devices = [dev] * chips
        self.answers = []
        self.profiler = None
        self.slice_counters = None

    def sync(self):
        """Wait for every card of the mesh (nothing on the CPU)."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- set-up -------------------------------------------------------------
    def setup(self):
        seed = self.seed % 2**64
        self.mesh = self.mt.make_mesh(1, len(self.devices), 1, devices=self.devices)
        self.image = images.smooth_image(self.w, self.h, seed, self.dev)
        self.filters = [self.mt.compile_source(f["source"]) for f in self.specs]
        rng = np.random.default_rng([seed, 1])
        self.calls = []
        for i in range(int(self.tr["pool"])):
            spec = self.specs[i % len(self.specs)]
            self.calls.append((i % len(self.specs), *draw_call(spec, rng, self.frames)))
        self.pick = np.random.default_rng([seed, 2])
        # warm-up: a whole sweep of every filter, its sampled frames cloned
        for i in range(len(self.specs)):
            out = self.call(i)
            kept = self.sample(i, out)
            del out
            self.sync()
            del kept

    def call(self, i: int) -> torch.Tensor:
        f_idx, ps, _ = self.calls[i % len(self.calls)]
        return self.filters[f_idx].render_sharded(
            self.image, mesh=self.mesh, num_frames=self.frames, width=self.w,
            height=self.h, params=ps)

    def sample(self, i: int, out: torch.Tensor) -> list:
        """[(frame index, a clone of that frame)] of call i's sampled frames."""
        return [(k, out[k].clone()) for k in self.calls[i % len(self.calls)][2]]

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, profiler=None) -> Window:
        nf, k = len(self.specs), int(self.tr["sample_calls_per_filter"])
        skip, n_trace = int(self.tr["trace_skip"]), int(self.tr["trace_calls"])
        self.profiler = profiler
        reservoir = [[] for _ in range(nf)]
        seen = [0] * nf
        lat, failed, pixels, traced = [], 0, 0, 0
        tracing = False
        before = None
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        i = 0
        while end < deadline:
            if profiler is not None and i == skip:
                before = program._snapshot()
                profiler.start()
                tracing = True
            with call_mark(tracing):
                t0 = time.perf_counter()
                try:
                    out = self.call(i)
                    self.sync()
                except Exception:  # noqa: BLE001 — a failed call is counted, not fatal
                    if not failed:
                        traceback.print_exc(file=sys.stderr)
                    out = None
                end = time.perf_counter()
            if tracing:
                traced += 1
                if traced == n_trace:
                    profiler.stop()
                    tracing = False
                    self.slice_counters = _counters_since(before)
            if out is None:
                failed += 1
                lat.append(seconds * 1e3)
            else:
                lat.append((end - t0) * 1e3)
                pixels += self.frames * self.w * self.h
                f_idx = i % len(self.calls) % nf
                seen[f_idx] += 1
                if len(reservoir[f_idx]) < k:
                    reservoir[f_idx].append((i, self.sample(i, out)))
                else:
                    j = int(self.pick.integers(seen[f_idx]))
                    if j < k:
                        reservoir[f_idx][j] = (i, self.sample(i, out))
                del out
            i += 1
        if tracing:
            profiler.stop()
            self.slice_counters = _counters_since(before)
        self.answers = [a for r in reservoir for a in sorted(r, key=lambda a: a[0])]
        elapsed = end - start
        values = {"mpix_per_s": stats.rate(pixels / 1e6, elapsed),
                  "call_p95_ms": stats.percentile(lat, 95)}
        return Window(attempted=i, failed=failed, start=start, seconds=elapsed, values=values,
                      timings={"call_ms": lat}, extra={"traced_calls": traced})

    def release(self):
        self.filters = None
        self.mesh = None
        self.sync()
        if self.dev.type == "cuda":
            for d in dict.fromkeys(self.devices):
                print(f"card {d.index}: memory_peak_bytes "
                      f"{torch.cuda.max_memory_allocated(d)}", file=sys.stderr)
            torch.cuda.empty_cache()

    def close(self):
        """Nothing outlives a closed loop's run."""

    # -- the comparison -----------------------------------------------------
    def compare(self, comparison, control: bool = False):
        for i, frames in self.answers:
            f_idx, ps, _ = self.calls[i % len(self.calls)]
            ref = manifest.reference(self.specs[f_idx]["reference"])
            for k, got in frames:
                t = float(self.ts[k])
                want = ref(ps, t, self.w, self.h, self.image, torch.float32, self.dev)
                if control:
                    got = ref(ps, t, self.w, self.h, self.image, torch.bfloat16, self.dev)
                comparison.add(got, want)
                del want, got

    # -- per-layer readings -------------------------------------------------
    def readings(self, window: Window, summary) -> dict:
        traced = window.extra["traced_calls"]
        if self.profiler is not None and self.profiler.prof is not None:
            busy = card_busy(self.profiler.prof)
            print("card busy %: " + ", ".join(f"{c} {v!r}" for c, v in busy.items()),
                  file=sys.stderr)
        return {"summary": summary, "frames": traced * self.frames, "calls": traced,
                "slice_counters": self.slice_counters}


def _counters_since(before):
    """The program's counters recorded since the snapshot `before`, or None
    where the program keeps no records (harness/program.py)."""
    after = program._snapshot()
    if before is None or after is None:
        return None
    old = before[0]["counters"]
    return {name: v - old.get(name, 0) for name, v in after[0]["counters"].items()}
