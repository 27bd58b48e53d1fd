"""BENCHMARK.json with the parked cells added back: a cell whose
`workloads/<cell>.json` holds `benchmark_entries` is built and tested
though the manifest does not list it yet."""

import json

from bench_torch.harness import manifest


def benchmark_with_parked() -> dict:
    bench = manifest.load_benchmark()
    listed = {w["name"] for w in bench["workloads"]}
    for path in sorted((manifest.BENCH_DIR / "workloads").glob("*.json")):
        entries = json.loads(path.read_text()).get("benchmark_entries")
        if entries and entries["workload"]["name"] not in listed:
            bench["workloads"].append(entries["workload"])
            bench["end_to_end"] += entries["end_to_end"]
            bench["per_layer"] += entries["per_layer"]
    return bench


def find(name: str):
    return manifest.find_cell(benchmark_with_parked(), name)
