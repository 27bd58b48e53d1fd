"""The parallel layer's assembly time a frame, in ms: the total of the
`mm.shard.assemble` spans (a frame's tiles moved to the mesh's first
device and joined) over the frames of the untraced calls
(harness/program.py). Nothing to read where the program records no
`mm.shard.assemble` span."""

from bench_torch.harness import program


def read(r: dict):
    got = program.untraced(r)
    if got is None or "mm.shard.assemble" not in got[0]:
        return None
    return program.span_ms_per_frame(r, "mm.shard.assemble")
