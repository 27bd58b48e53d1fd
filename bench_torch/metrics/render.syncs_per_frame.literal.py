"""Host waits on the device a frame caused by the evaluator's literals and
internals and the coordinate grids' offsets: the count of
`mm.sync.literal` spans over the frames of the profiled slice
(harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.syncs_per_frame(r, "literal")
