"""Every name in BENCHMARK.json finds its files, and the manifest keeps the
contract's shapes."""

import json
import re

import pytest

from bench_torch.harness import manifest
from bench_torch.tests import _cells

BENCH = manifest.load_benchmark()
#: with the parked cells, whose entries wait in their workloads file
ALL = _cells.benchmark_with_parked()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_torch/run.py"]
    assert BENCH["paths"] == ["bench_torch"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.find_cell(ALL, cell)
    assert c.config["name"] == c.entry["config"]
    assert (manifest.BENCH_DIR / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert manifest.driver(c.traffic["driver"]).Driver
    assert c.settings["limits"]
    for f in c.config["filters"]:
        assert callable(manifest.reference(f["reference"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(manifest.metric_reader(metric).read)


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["listed", "with_parked"])
def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    lines = [c["source"] for c in bench["configs"]]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        lines += [e[k] for k in ("why", "layer") if k in e]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["chips"] == 1
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    assert len(json.dumps(bench)) < 64 * 1024


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_torch/")
        assert c["reduced"] == manifest._json(manifest.ROOT / c["file"])["reduced"]


def test_a_per_layer_metric_moves_a_metric_its_cells_report():
    for m in ALL["per_layer"]:
        for cell in m["workloads"]:
            e2e, _ = manifest.reported(ALL, cell)
            assert m["moves"] in {x["name"] for x in e2e}
