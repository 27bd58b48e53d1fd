"""The benchmark of the PyTorch and CUDA port (`mathmap_tpu_torch`).

`python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once on the GPU and prints one JSON line.
Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel count is a file of its own, found by name:

- `configs/<config>.json`: the filters (their sources, copied), the input,
  the params' distributions and the plain reference of each filter;
- `traffic/<traffic>.json`: the mix's parameters and the driver that
  reads them (`drivers/<driver>.py`);
- `workloads/<cell>.json`: the limits of the correctness comparison and
  the readings they were set from (a cell not yet in BENCHMARK.json keeps
  its entries there, under `benchmark_entries`);
- `metrics/<metric>.py`: the reader of one per-layer metric;
- `roofline/<kernel>.py`: a kernel's name, operations and bytes.

It imports the program (`mathmap_tpu_torch`) and nothing else of the repo.
"""
