#!/usr/bin/env python3
"""Readings that set a cell's comparison limits, in one process.

    python3 bench_torch/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,... --control-seeds 7,8,9

For each of `--seeds`, a short window of the program at the cell's sizes
and load, then the comparison of its sampled answers with the plain
reference: the lower readings. For each of `--control-seeds`, the same
window's sampled answers replaced by the reference computed in bfloat16,
the nearest precision below the configurations' float32: the upper
readings. Prints one JSON line a seed and a last line with, per number,
the largest sound reading and the smallest control reading. The
benchmark's own runs never run the control. Needs the GPU.
"""

import sys
import time
from pathlib import Path


def main(argv) -> int:
    import argparse
    import gc
    import json

    import torch

    from bench_torch.harness import compare, device, manifest
    from bench_torch.harness.cell import make_driver

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--cpu", action="store_true", help="the harness's own tests only")
    args = ap.parse_args(argv)
    cell = manifest.find_cell(manifest.load_benchmark(), args.workload)
    dev = torch.device("cpu") if args.cpu else device.require_cuda(int(cell.entry["chips"]))
    lower, upper = {}, {}
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        drv = make_driver(cell, seed, dev)
        try:
            drv.setup()
            win = drv.window(args.seconds)
            drv.release()
            gc.collect()
            comp = compare.Comparison()
            drv.compare(comp, control=control)
        finally:
            drv.close()
        numbers = comp.numbers()
        into = upper if control else lower
        for k, v in numbers.items():
            into[k] = (min if control else max)(into.get(k, v), v)
        print(json.dumps({"seed": seed, "control": control, "answers": comp.answers,
                          "attempted": win.attempted, "failed": win.failed,
                          "numbers": numbers, "seconds": time.perf_counter() - t}), flush=True)
        del drv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
