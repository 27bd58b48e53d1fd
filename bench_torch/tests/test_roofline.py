"""Kernel counts from shapes: B1's bytes, B3's operations from the loop's
iterations as the plain reference counts them."""

import torch

from bench_torch.harness import manifest
from bench_torch.reference import generative
from bench_torch.roofline import b1, b3


def test_b1_bytes_from_shapes():
    # a 4K u8 image in, coordinates and four float32 planes per output pixel
    assert b1.launch_bytes(2160, 3840, 2160, 3840, 1) == 232_243_200
    assert b1.launch_bytes(1080, 1920, 1080, 1920, 4) == 1080 * 1920 * (16 + 24)


def _scalar_iterations(params, w, h):
    total = 0
    zoom, cx, cy, maxiter = params["zoom"], params["cx"], params["cy"], 64
    for j in range(h):
        for i in range(w):
            x, y = i + 0.5 - w / 2, h / 2 - 0.5 - j
            c = complex(x / (w / 2) * 2 / zoom + cx, y / (w / 2) * 2 / zoom + cy)
            z, n = 0j, 0
            while abs(z) ** 2 < 4 and n < maxiter:
                z = z * z + c
                n += 1
            total += n
    return total


def test_b3_operations_from_the_reference_count():
    p = {"zoom": 1.3, "cx": 0.3, "cy": 0.28}
    counted = generative.mandelbrot_iterations(p, 40, 24, torch.device("cpu"))
    assert abs(counted - _scalar_iterations(p, 40, 24)) <= 3   # float32 against float64
    cfg = manifest.find_cell(manifest.load_benchmark(), "generative.batch_4k").config
    loop = next(f["loop"] for f in cfg["filters"] if "loop" in f)
    assert b3.operations(counted, loop["ops_per_iteration"]) == counted * 15
