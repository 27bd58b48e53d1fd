"""The comparison's control: the plain reference computed in bfloat16, the
nearest precision below the configurations' float32, in the program's
place, fails each cell's limits; the program itself passes them. At a size
a test run holds, on the CPU."""

import pytest
import torch

from bench_torch.harness import compare
from bench_torch.tests import _cells
from bench_torch.harness.cell import make_driver

SIZES = {
    "distort.frames_4k": {"width": 320, "height": 180},
    "generative.batch_4k": {"width": 320, "height": 180, "jobs": 2},
    "distort.frames_1080p": {"width": 320, "height": 180},
    "distort.service_1080p": {"width": 320, "height": 180, "rate_per_s": 6.0,
                              "lead_s": 1.0, "grace_s": 20.0, "sample": 4},
}
SMALL = {"pool": 12, "sample_per_filter": 1}


def _readings(cell_name, seed, control):
    cell = _cells.find(cell_name)
    over = dict(SIZES[cell_name])
    if cell.traffic["driver"] == "closed":
        over.update(SMALL)
    drv = make_driver(cell, seed, torch.device("cpu"), over)
    try:
        drv.setup()
        drv.window(1.0)
        drv.release()
        comp = compare.Comparison()
        drv.compare(comp, control=control)
    finally:
        drv.close()
    return compare.judge(comp.numbers(), cell.settings["limits"]), comp


@pytest.mark.parametrize("cell_name", sorted(SIZES))
def test_control_fails_and_program_passes(cell_name):
    (ok, checks), comp = _readings(cell_name, 2**31 + 77, control=True)
    assert comp.answers > 0
    assert not ok, checks
    (ok, checks), comp = _readings(cell_name, 2**31 + 78, control=False)
    assert comp.answers > 0
    assert ok, checks
