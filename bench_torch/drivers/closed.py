"""Closed loop of API calls: one call at a time, the next sent when the
last one's output is on the device.

Traffic parameters (traffic/<mix>.json):

- `call`: "render" (Filter.render of one frame) or "render_batch"
  (Filter.render_batch of `jobs` jobs);
- `width`, `height`: the canvas; an input image, where the configuration
  has one, is made at that size from the seed and staged on the device
  once, before the window (shared by a batch's jobs);
- `jobs`: jobs a call (1 for render);
- `pool`: calls drawn from the seed; the window cycles through them. Call
  i renders the configuration's filter i modulo their number, each with
  its own params and t;
- `sample_per_filter`: answers kept per filter for the comparison, a
  uniform sample of the window's calls drawn from the seed;
- `trace_skip`, `trace_calls`: the calls a traced run profiles.

End-to-end values: `mpix_per_s`, the output pixels of every call that
completed over the window's seconds (from its start to the end of its
last call), and `call_p95_ms`, the 95th percentile of every call's host
time from the call to the synchronize after it; a failed call counts as
the whole window.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from bench_torch.drivers import Window
from bench_torch.harness import images, manifest, params, stats
from bench_torch.harness.device import synchronizer
from bench_torch.harness.trace import call_mark


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device, mt, traffic: dict):
        self.cell, self.seed, self.dev, self.mt = cell, seed, dev, mt
        self.tr = traffic
        self.w, self.h = int(traffic["width"]), int(traffic["height"])
        self.batch = traffic["call"] == "render_batch"
        self.jobs = int(traffic["jobs"]) if self.batch else 1
        self.specs = cell.config["filters"]
        self.sync = synchronizer(dev)
        self.answers = []

    # -- set-up -------------------------------------------------------------
    def setup(self):
        cfg = self.cell.config
        seed = self.seed % 2**64
        self.image = None
        if cfg["input"]["kind"] == "smooth":
            self.image = images.smooth_image(self.w, self.h, seed, self.dev)
        self.filters = [self.mt.compile_source(f["source"]) for f in self.specs]
        rng = np.random.default_rng([seed, 1])
        self.calls = []
        for i in range(int(self.tr["pool"])):
            spec = self.specs[i % len(self.specs)]
            ps = [params.draw(spec.get("params", {}), rng, job=k) for k in range(self.jobs)]
            ts = [params.draw_t(rng) for _ in range(self.jobs)]
            self.calls.append((i % len(self.specs), ps, ts))
        self.pick = np.random.default_rng([seed, 2])
        # warm-up: every filter at the window's shapes, holding as many
        # outputs as the sample will, so the allocator's pool is grown
        k = int(self.tr["sample_per_filter"])
        held = [self.call(i) for i in range((k + 1) * len(self.specs))]
        self.sync()
        del held

    def call(self, i: int):
        f_idx, ps, ts = self.calls[i % len(self.calls)]
        f = self.filters[f_idx]
        inputs = () if self.image is None else (self.image,)
        if self.batch:
            inputs = tuple(self.mt.shared(a) for a in inputs)
            return f.render_batch(*inputs, ts=np.asarray(ts, np.float32), params=ps,
                                  width=self.w, height=self.h, device=self.dev)
        return f.render(*inputs, width=self.w, height=self.h, t=ts[0], params=ps[0],
                        device=self.dev)

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, profiler=None) -> Window:
        nf, k = len(self.specs), int(self.tr["sample_per_filter"])
        skip, n_trace = int(self.tr["trace_skip"]), int(self.tr["trace_calls"])
        reservoir = [[] for _ in range(nf)]
        seen = [0] * nf
        lat, failed, pixels, traced = [], 0, 0, 0
        tracing = False
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        i = 0
        while end < deadline:
            if profiler is not None and i == skip:
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
            if out is None:
                failed += 1
                lat.append(seconds * 1e3)
            else:
                lat.append((end - t0) * 1e3)
                pixels += self.jobs * self.w * self.h
                f_idx = i % len(self.calls) % nf
                seen[f_idx] += 1
                if len(reservoir[f_idx]) < k:
                    reservoir[f_idx].append((i, out))
                else:
                    j = int(self.pick.integers(seen[f_idx]))
                    if j < k:
                        reservoir[f_idx][j] = (i, out)
            i += 1
        if tracing:
            profiler.stop()
        self.answers = [a for r in reservoir for a in sorted(r, key=lambda a: a[0])]
        elapsed = end - start
        values = {"mpix_per_s": stats.rate(pixels / 1e6, elapsed),
                  "call_p95_ms": stats.percentile(lat, 95)}
        return Window(attempted=i, failed=failed, start=start, seconds=elapsed, values=values,
                      timings={"call_ms": lat}, extra={"traced_calls": traced})

    def release(self):
        self.filters = None
        self.sync()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        """Nothing outlives a closed loop's run."""

    # -- the comparison -----------------------------------------------------
    def compare(self, comparison, control: bool = False):
        for i, out in self.answers:
            f_idx, ps, ts = self.calls[i % len(self.calls)]
            ref = manifest.reference(self.specs[f_idx]["reference"])
            outs = out if self.batch else out[None]
            for job in range(self.jobs):
                want = ref(ps[job], ts[job], self.w, self.h, self.image, torch.float32, self.dev)
                got = (ref(ps[job], ts[job], self.w, self.h, self.image, torch.bfloat16,
                           self.dev) if control else outs[job])
                comparison.add(got, want)
                del want, got

    # -- per-layer readings -------------------------------------------------
    def readings(self, window: Window, summary) -> dict:
        traced = window.extra["traced_calls"]
        skip = int(self.tr["trace_skip"])
        out = {"summary": summary, "frames": traced * self.jobs, "calls": traced}
        if self.image is not None:
            b1 = manifest.roofline("b1")
            out["b1_bytes_per_launch"] = b1.launch_bytes(
                self.h, self.w, self.image.shape[0], self.image.shape[1],
                self.image.element_size())
        loop_ops = 0
        for i in range(skip, skip + traced):
            f_idx, ps, _ = self.calls[i % len(self.calls)]
            loop = self.specs[f_idx].get("loop")
            if loop is not None:
                count = manifest.reference(loop["iterations"])
                iters = sum(count(p, self.w, self.h, self.dev) for p in ps)
                loop_ops += manifest.roofline("b3").operations(iters, loop["ops_per_iteration"])
        if loop_ops:
            out["b3_operations"] = loop_ops
        return out
