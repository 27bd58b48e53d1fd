"""Host waits on the device a frame caused by B3's wrapper and the eager
loop's mask readbacks: the count of `mm.sync.loop` spans over the frames
of the profiled slice (harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.syncs_per_frame(r, "loop")
