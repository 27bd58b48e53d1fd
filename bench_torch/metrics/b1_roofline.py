"""Kernel B1's share of its roofline, in %: the least time of its
launches in the traced window (each launch's bytes, counted from the
cell's shapes by roofline/b1.py, over the HBM rate) over their device
time. Nothing to read where B1 did not run."""

from bench_torch.harness import peaks
from bench_torch.roofline import b1


def read(r: dict):
    per_launch = r.get("b1_bytes_per_launch")
    if per_launch is None:
        return None
    launches, us = r["summary"].kernel(b1.KERNEL)
    if not launches or us <= 0:
        return None
    least_s = launches * per_launch / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
