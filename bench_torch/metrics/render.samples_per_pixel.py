"""Points the filter's walks evaluate a pixel: the program's counter
`render.samples` (s²·h·w a frame under supersample s on the grid scheme,
(h+1)(w+1) + h·w under corners, h·w with supersampling off) over its
counter `render.pixels` (the output pixels of every frame it rendered),
both over every call of the process, traced or not, warm-up included.
Nothing to read where the program keeps no `render.samples` counter, as a
program from before it does."""

from bench_torch.harness import program


def read(r: dict):
    got = program._snapshot()
    if got is None:
        return None
    counters = got[0]["counters"]
    samples, pixels = counters.get("render.samples"), counters.get("render.pixels")
    if not samples or not pixels:
        return None
    return samples / pixels
