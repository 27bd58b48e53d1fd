#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the GPU.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `mathmap_tpu_torch`. It sets up
(inputs and params from the seed, filters compiled, kernels built into the
package's own build directory, every shape of the cell's traffic warmed),
measures for `--seconds` seconds, compares the window's answers with the
plain reference, and prints one JSON line: the end-to-end metrics with
`--trace 0`, the per-layer metrics and the trace's breakdown with
`--trace 1`. It exits with 2, printing no result, where there is no CUDA
device or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench_torch.harness.cell import main

    sys.exit(main(sys.argv[1:], T_START))
