"""The evaluator's own host time a frame, in ms: the self time of the
`mm.evaluate` spans (their mm.sync.* children left out: the walk of the
filter body, the grids, the default params and the launches) over the
frames of the untraced calls (harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.span_ms_per_frame(r, "mm.evaluate", "self_ns")
