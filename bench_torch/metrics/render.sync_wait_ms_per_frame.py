"""The host's time blocked on the device a frame, in ms: the summed
duration of every `mm.sync.*` span over the frames of the untraced calls
(harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.sync_ms_per_frame(r)
