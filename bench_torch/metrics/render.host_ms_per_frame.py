"""The program's host time a frame, in ms: its `mm.call` spans (one public
render entry each, from entry to return), less the kernels' builds inside
them, over the frames of every call the run made with no profiler
recording (harness/program.py), a batch's jobs one frame each."""

from bench_torch.harness import program


def read(r: dict):
    return program.host_ms_per_frame(r)
