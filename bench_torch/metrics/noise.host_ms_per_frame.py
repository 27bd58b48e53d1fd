"""The noise layer's host time a frame, in ms: the total of the `mm.noise`
spans (each one `noise` call's Perlin evaluation enqueued, the loop
probes' calls included) over the frames of the untraced calls
(harness/program.py). Nothing to read where the program records no
`mm.noise` span."""

from bench_torch.harness import program


def read(r: dict):
    got = program.untraced(r)
    if got is None or "mm.noise" not in got[0]:
        return None
    return program.span_ms_per_frame(r, "mm.noise")
