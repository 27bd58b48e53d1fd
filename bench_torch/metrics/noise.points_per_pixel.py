"""Perlin evaluations a pixel: the program's counter `noise.points` (the
points each `noise` call evaluates, the loop probes' included) over its
counter `render.pixels` (the output pixels of every frame it rendered),
both over every call of the process, traced or not, warm-up included.
Nothing to read where the program keeps no `noise.points` counter."""

from bench_torch.harness import program


def read(r: dict):
    got = program._snapshot()
    if got is None:
        return None
    counters = got[0]["counters"]
    points, pixels = counters.get("noise.points"), counters.get("render.pixels")
    if not points or not pixels:
        return None
    return points / pixels
