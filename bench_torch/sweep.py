#!/usr/bin/env python3
"""The service's rate sweep: the open-loop cell's window at several fixed
rates, one service set up once, to find the highest rate it sustains.

    python3 bench_torch/sweep.py --workload distort.service_1080p \
        --rates 2,4,6,8 --seconds 20 --seed 1

Prints one JSON line a rate: requests, failed, p50 and p95 latency (ms,
from the due time), the mean latency of the window's first and last
quarters of requests (a backlog that grows shows as the last above the
first) and the generator's p95 lateness. Needs the GPU.
"""

import sys
from pathlib import Path


def main(argv) -> int:
    import argparse
    import json

    from bench_torch.harness import device, manifest, stats
    from bench_torch.harness.cell import make_driver

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = manifest.find_cell(manifest.load_benchmark(), args.workload)
    dev = device.require_cuda(int(cell.entry["chips"]))
    drv = make_driver(cell, args.seed, dev)
    try:
        drv.setup()
        for rate in (float(r) for r in args.rates.split(",")):
            win = drv.window(args.seconds, rate=rate)
            lat = win.timings["request_ms"]
            q = max(len(lat) // 4, 1)
            print(json.dumps({
                "rate_per_s": rate, "requests": win.attempted, "failed": win.failed,
                "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95),
                "first_quarter_mean_ms": sum(lat[:q]) / q,
                "last_quarter_mean_ms": sum(lat[-q:]) / q,
                "send_late_p95_ms": stats.percentile(win.timings["send_late_ms"], 95)}),
                flush=True)
    finally:
        drv.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
