"""Closed loop of antialiased t-sweeps on one device: one
`Filter.render_animation` call at a time, the next sent when the device
has finished the last one. The sharded driver's loop, sampling and
comparison (drivers/sharded.py) with no mesh: the whole sweep renders
into one preallocated output on the device.

Traffic parameters (traffic/<mix>.json): those of drivers/sharded.py.

The configuration gives the input (`input`: `{"kind": "textured",
"levels": n}`, the seeded smooth image plus a texture of -n..n levels,
made at the canvas's size on the device once, before the window) and the
render's options (`options`: the RenderOptions fields in OPTIONS; its
other keys describe the output). End-to-end values as drivers/sharded.py
gives them.
"""

from __future__ import annotations

import numpy as np

from bench_torch.drivers import sharded
from bench_torch.harness import images, manifest

#: the RenderOptions fields a configuration's `options` sets
OPTIONS = ("interpolation", "edge_x", "edge_y", "edge_color", "supersample",
           "supersample_scheme")


def render_options(mt, config: dict):
    """The program's RenderOptions from the configuration's `options`."""
    opts = {k: config["options"][k] for k in OPTIONS}
    opts["edge_color"] = tuple(float(c) for c in opts["edge_color"])
    return mt.RenderOptions(**opts)


class Driver(sharded.Driver):
    def setup(self):
        cfg = self.cell.config
        seed = self.seed % 2**64
        self.options = render_options(self.mt, cfg)
        self.image = images.textured(images.smooth_image(self.w, self.h, seed, self.dev),
                                     int(cfg["input"]["levels"]), seed)
        self.filters = [self.mt.compile_source(f["source"]) for f in self.specs]
        rng = np.random.default_rng([seed, 1])
        self.calls = []
        for i in range(int(self.tr["pool"])):
            spec = self.specs[i % len(self.specs)]
            self.calls.append((i % len(self.specs), *sharded.draw_call(spec, rng, self.frames)))
        self.pick = np.random.default_rng([seed, 2])
        # warm-up: a whole sweep of every filter, its sampled frames cloned
        for i in range(len(self.specs)):
            out = self.call(i)
            kept = self.sample(i, out)
            del out
            self.sync()
            del kept

    def call(self, i: int):
        f_idx, ps, _ = self.calls[i % len(self.calls)]
        return self.filters[f_idx].render_animation(
            self.image, num_frames=self.frames, width=self.w, height=self.h,
            options=self.options, params=ps, device=self.dev)

    def readings(self, window, summary) -> dict:
        """The sharded driver's, with B1's bytes a launch: each of a frame's
        s x s walks samples the whole source once."""
        out = super().readings(window, summary)
        out["b1_bytes_per_launch"] = manifest.roofline("b1").launch_bytes(
            self.h, self.w, self.image.shape[0], self.image.shape[1],
            self.image.element_size())
        return out
