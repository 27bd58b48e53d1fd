"""The calibration tool's readings: a sound seed reads under the cell's
limits, a control seed over them (the CPU, at the cell's own size)."""

import io
import json
from contextlib import redirect_stdout

from bench_torch import calibrate
from bench_torch.harness import compare, manifest


def test_readings_of_program_and_control():
    out = io.StringIO()
    with redirect_stdout(out):
        assert calibrate.main(["--workload", "distort.frames_1080p", "--seconds", "0.5",
                               "--seeds", "5", "--control-seeds", "6", "--cpu"]) == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    limits = manifest.find_cell(manifest.load_benchmark(), "distort.frames_1080p").settings["limits"]
    assert compare.judge(last["lower"], limits)[0]
    assert not compare.judge(last["upper"], limits)[0]
