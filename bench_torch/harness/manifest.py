"""Find a cell's parts by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names its configuration and its traffic
mix. The configuration's file is the `file` of its `configs` entry; the
mix is `traffic/<traffic>.json`, whose `driver` names
`drivers/<driver>.py`; the cell's own settings (the comparison's limits)
are `workloads/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. Adding any of them is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """Import the file at `path` under a module name made from it (metric
    files carry dots in their names)."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    entry: dict          # the BENCHMARK.json workload entry
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    settings: dict       # workloads/<cell>.json
    end_to_end: list     # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list      # BENCHMARK.json per_layer entries this cell reports


def reported(bench: dict, name: str) -> tuple:
    """The end-to-end and per-layer metrics a cell reports: an entry with
    `workloads` where it lists the cell; a per-layer entry without it
    wherever its `moves` metric is reported."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    settings = _json(BENCH_DIR / "workloads" / f"{name}.json")
    e2e, per_layer = reported(bench, name)
    return Cell(name, entry, config, traffic, settings, e2e, per_layer)


def driver(name: str):
    return importlib.import_module(f"bench_torch.drivers.{name}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "bench_metric_")


def reference(spec: str):
    """'module.function' -> the function in reference/<module>.py."""
    module, func = spec.rsplit(".", 1)
    return getattr(importlib.import_module(f"bench_torch.reference.{module}"), func)


def roofline(kernel: str):
    return importlib.import_module(f"bench_torch.roofline.{kernel}")
