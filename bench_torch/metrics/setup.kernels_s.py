"""The seconds the program spent on its kernels' libraries: loading each
from the build directory, or building it with nvcc, and emitting B3's
sources. Its `mm.build` spans over the run, all of them in set-up, where
the warm-up runs every shape the window will (harness/program.py)."""

from bench_torch.harness import program


def read(r: dict):
    return program.build_s(r)
