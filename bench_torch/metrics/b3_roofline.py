"""Kernel B3's share of its roofline, in %: the least time of the loop
work in the traced window (the profiled calls' pixel iterations, counted
by the plain reference, times the loop body's operations, over the fp32
rate: roofline/b3.py) over the device time of B3's launches. Nothing to
read where B3 did not run."""

from bench_torch.harness import peaks
from bench_torch.roofline import b3


def read(r: dict):
    ops = r.get("b3_operations")
    if not ops:
        return None
    launches, us = r["summary"].kernel(b3.KERNEL)
    if not launches or us <= 0:
        return None
    return 100.0 * (ops / peaks.FP32_OPS_PER_S) / (us / 1e6)
