"""Walks of the filter body a frame: the program's counter `render.walks`
(s² a frame under supersample s on the grid scheme, 2 under corners, 1
with supersampling off; each an `mm.evaluate`) over the profiled slice's
calls, as the driver read it before and after the slice
(`slice_counters`), over the slice's frames. Nothing to read where the
program counts no `render.walks` there, as a program from before the
counter does."""


def read(r: dict):
    counters = r.get("slice_counters")
    if not counters or not counters.get("render.walks") or not r.get("frames"):
        return None
    return counters["render.walks"] / r["frames"]
