"""Host waits on the device a frame caused by the params' and the defaults'
values and LUTs copied to the device: the count of `mm.sync.param` spans
over the frames of the profiled slice (harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.syncs_per_frame(r, "param")
