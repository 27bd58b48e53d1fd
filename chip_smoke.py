#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mathmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases, each printing its own lines:

1. card: the GPU's name and power limit (nvidia-smi), CUDA and torch
   versions, and the build of the kernel library from
   mathmap_tpu_torch/csrc/ by nvcc (its time and ptxas register report);
2. kernel vs plain: the CUDA origVal sampler against its plain PyTorch
   version on the same CUDA tensors, at 1920x1080 and 3840x2160, for every
   interpolation x edge pair x source dtype, at rtol=1e-4, atol=1e-5;
3. main path: fisheye, twirl and pond through compile_file ->
   Filter.render(device="cuda") at 1920x1080 and 3840x2160; every render
   must launch the sampler kernel once, and the 1080p renders of a smooth
   seeded image must match the port's CPU renders (rtol=1e-4, atol=1e-5;
   uint8 output within 1 LSB);
4. timings on the card: median fenced render time per filter and size, and
   the kernel alone against the plain version (whose outputs are held
   against each other too).

The line before the last is the JSON record of the kernels; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA GPU, or without the package beside this file, the script
exits non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FILTERS = ("fisheye", "twirl", "pond")
#: one non-default param set per filter (inside each declared range)
OTHER_PARAMS = {
    "fisheye": {"strength": 1.5},
    "twirl": {"angle": -4.0},
    "pond": {"amplitude": 9.0, "wavelength": 31.0, "phase": 1.1},
}
SIZES = ((1920, 1080), (3840, 2160))
INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)
RTOL, ATOL = 1e-4, 1e-5
TIMED_RENDERS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def seeded_image(w: int, h: int, seed: int):
    """(h, w, 4) float32 in [0, 1] and its uint8 rounding, from numpy."""
    f32 = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    u8 = np.floor(f32 * 255.0 + 0.5).astype(np.uint8)
    return f32, u8


def smooth_image(w: int, h: int, seed: int, fade: bool = True):
    """(h, w, 4) float32 in [0, 1] and its uint8 rounding: a seeded 8x5
    grid of random colors, bilinearly interpolated and (with `fade`) faded
    to the edge color (transparent black) at the border by a sine window,
    so the sampled function changes by at most ~0.008 per pixel, outside
    the image too. Used where a render on the card is held against a render
    on the CPU: the two compute the warp's coordinates with their own libm,
    which differ by a few ulp, and an image that changes by up to 1 per
    pixel (noise, or the drop to the edge color at a border) turns that into
    an output difference of the same size (chip_profile.py measures
    both)."""
    coarse = np.random.RandomState(seed).rand(6, 9, 4)
    v = (np.arange(h) + 0.5) * (5 / h)
    u = (np.arange(w) + 0.5) * (8 / w)
    iv, iu = np.floor(v).astype(int), np.floor(u).astype(int)
    fv, fu = (v - iv)[:, None, None], (u - iu)[None, :, None]
    rows = coarse[iv] * (1 - fv) + coarse[iv + 1] * fv
    img = rows[:, iu] * (1 - fu) + rows[:, iu + 1] * fu
    if fade:
        img = img * (np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None, None]
                     * np.sin(np.pi * (np.arange(w) + 0.5) / w)[None, :, None])
    f32 = img.astype(np.float32)
    u8 = np.floor(f32 * 255.0 + 0.5).astype(np.uint8)
    return f32, u8


def probe_coordinates(w: int, h: int, seed: int):
    """(h, w) world-coordinate grids in four row bands: in range, exact
    texel centres, far outside (±3·W), and within 3 px of an edge."""
    rs = np.random.RandomState(seed)
    x = np.empty((h, w), np.float32)
    y = np.empty((h, w), np.float32)
    bands = np.array_split(np.arange(h), 4)
    n = [len(b) * w for b in bands]
    x[bands[0]] = rs.uniform(-w / 2, w / 2, n[0]).reshape(-1, w)
    y[bands[0]] = rs.uniform(-h / 2, h / 2, n[0]).reshape(-1, w)
    x[bands[1]] = (rs.randint(0, w, n[1]) + 0.5 - w / 2).reshape(-1, w)
    y[bands[1]] = (h / 2 - 0.5 - rs.randint(0, h, n[1])).reshape(-1, w)
    x[bands[2]] = rs.uniform(-3 * w, 3 * w, n[2]).reshape(-1, w)
    y[bands[2]] = rs.uniform(-3 * w, 3 * w, n[2]).reshape(-1, w)
    ex = rs.choice([-w / 2, w / 2], n[3]) + rs.uniform(-3, 3, n[3])
    ey = rs.choice([-h / 2, h / 2], n[3]) + rs.uniform(-3, 3, n[3])
    x[bands[3]] = ex.reshape(-1, w)
    y[bands[3]] = ey.reshape(-1, w)
    return x, y


def smooth_warp(w: int, h: int, dev):
    """(h, w) world coordinates of a mild rotation + zoom: the access
    pattern of the distortion suite, for timing the kernel alone."""
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - w * 0.5
    ys = h * 0.5 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
    x, y = torch.meshgrid(xs, ys, indexing="xy")
    c, s = 0.9 * np.cos(0.3), 0.9 * np.sin(0.3)
    return (c * x - s * y).contiguous(), (s * x + c * y).contiguous()


def event_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def render_median_ms(f, img, dev, n: int = TIMED_RENDERS) -> float:
    """Median host ms of `n` renders, each fenced by synchronize, after two
    warm-up renders."""
    for _ in range(2):
        f.render(img, device=dev)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f.render(img, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_close(name, got, want, rtol=RTOL, atol=ATOL) -> float:
    err = (got - want).abs()
    if not bool(torch.all(err <= atol + rtol * want.abs())):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{float(err.max())} (rtol={rtol}, atol={atol})")
    return float(err.max())


def phase_card(build):
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    lib = build.library()
    print(f"kernel library: {lib.path.relative_to(ROOT)} built by nvcc from "
          f"{build.CSRC.relative_to(ROOT)}/ in {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return card


def phase_kernel_vs_plain(K, dev) -> float:
    """At every shape of the main path: all interpolations x edge pairs x
    source dtypes."""
    worst = 0.0
    for seed, (w, h) in enumerate(SIZES):
        f32, u8 = seeded_image(w, h, seed=1 + 2 * seed)
        srcs = {"f32": torch.from_numpy(f32).to(dev),
                "u8": torch.from_numpy(u8).to(dev)}
        x, y = (torch.from_numpy(a).to(dev)
                for a in probe_coordinates(w, h, seed=2 + 2 * seed))
        for interp in INTERPOLATIONS:
            for ex, ey in EDGE_PAIRS:
                for dname, pix in srcs.items():
                    args = (pix, x, y, interp, ex, ey, EDGE_COLOR)
                    got = K.sample_image(*args)
                    want = K.sample_image_reference(*args)
                    torch.cuda.synchronize()
                    err = check_close(f"{w}x{h} {interp} {ex}/{ey} {dname}",
                                      got, want)
                    worst = max(worst, err)
                    print(f"kernel vs plain {w}x{h} {interp:8s} "
                          f"{ex + '/' + ey:15s} {dname:3s}: max abs err {err:.3e}")
    n = len(SIZES) * len(INTERPOLATIONS) * len(EDGE_PAIRS) * 2
    print(f"kernel vs plain: all {n} cases agree, worst max abs err {worst:.3e}")
    return worst


def phase_main_path(mt, K, dev, filters):
    """Every render goes through the kernel; 1080p matches the CPU port."""
    K.sample_image.launches = 0
    renders = 0
    for (w, h) in SIZES:
        f32, u8 = smooth_image(w, h, seed=3)
        u8_dev = torch.from_numpy(u8).to(dev)
        for name in FILTERS:
            f = filters[name]
            cases = [("u8", u8_dev, {}, "float32"),
                     ("u8", u8_dev, OTHER_PARAMS[name], "float32")]
            if w == SIZES[0][0]:
                cases += [("f32", torch.from_numpy(f32).to(dev), {}, "float32"),
                          ("u8", u8_dev, {}, "uint8")]
            for dname, img, params, out_dtype in cases:
                opts = mt.RenderOptions(output_dtype=out_dtype)
                before = K.sample_image.launches
                out = f.render(img, params=params, options=opts, device=dev)
                torch.cuda.synchronize()
                renders += 1
                if K.sample_image.launches != before + 1:
                    raise AssertionError(
                        f"{name} {w}x{h}: {K.sample_image.launches - before} "
                        f"sampler launches in one render, expected 1")
                if tuple(out.shape) != (h, w, 4) or out.device != dev:
                    raise AssertionError(f"{name}: bad output {tuple(out.shape)} on {out.device}")
                if out_dtype == "float32" and not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name} {w}x{h}: non-finite output")
                tag = (f"{name:7s} {w}x{h} {dname:3s} in, {out_dtype:7s} out, "
                       f"{'default' if not params else 'other'} params")
                if w != SIZES[0][0]:
                    print(f"main path {tag}: ok")
                    continue
                cpu_img = img.cpu()
                ref = f.render(cpu_img, params=params, options=opts, device="cpu")
                if out_dtype == "uint8":
                    lsb = int((out.cpu().int() - ref.int()).abs().max())
                    if lsb > 1:
                        raise AssertionError(f"{tag}: {lsb} LSB from the CPU render")
                    print(f"main path {tag}: max {lsb} LSB from the CPU render")
                else:
                    err = check_close(tag, out.cpu(), ref)
                    print(f"main path {tag}: max abs err {err:.3e} vs the CPU render")
    launches = K.sample_image.launches
    if launches != renders:
        raise AssertionError(f"{launches} sampler launches for {renders} renders")
    print(f"main path: {renders} GPU renders, {launches} sampler kernel launches")
    return launches


def phase_timings(mt, K, dev, filters, card):
    """Fenced render medians, and the kernel alone vs its plain version."""
    kernel_4k = None
    for (w, h) in SIZES:
        _, u8 = seeded_image(w, h, seed=4)
        img = torch.from_numpy(u8).to(dev)
        for name in FILTERS:
            ms = render_median_ms(filters[name], img, dev)
            print(f"timing render {name:7s} {w}x{h} u8 in: median {ms:.3f} "
                  f"ms/frame of {TIMED_RENDERS}, {w * h / ms / 1e3:.1f} Mpix/s "
                  f"[{card}]")
        x, y = smooth_warp(w, h, dev)
        for dname, pix in (("u8", img),
                           ("f32", (img.float() / 255.0).contiguous())):
            for interp in INTERPOLATIONS:
                args = (pix, x, y, interp, "color", "color", EDGE_COLOR)
                runs = [event_ms(lambda: K.sample_image_reference(*args), 5),
                        event_ms(lambda: K.sample_image(*args), 50),
                        event_ms(lambda: K.sample_image(*args), 50),
                        event_ms(lambda: K.sample_image_reference(*args), 5)]
                plain_ms = (runs[0] + runs[3]) / 2
                kernel_ms = (runs[1] + runs[2]) / 2
                err = check_close(f"timed {w}x{h} {dname} {interp}",
                                  K.sample_image(*args),
                                  K.sample_image_reference(*args))
                print(f"timing kernel {w}x{h} {dname:3s} {interp:8s}: "
                      f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
                      f"({plain_ms / kernel_ms:.1f}x), max abs err "
                      f"{err:.3e} [{card}]")
                if (w, h, dname, interp) == (*SIZES[1], "u8", "bilinear"):
                    kernel_4k = (kernel_ms, plain_ms)
    return kernel_4k


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    if not (ROOT / "mathmap_tpu_torch").is_dir():
        print(f"chip_smoke: mathmap_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.kernels import build
    from mathmap_tpu_torch.kernels import sample_image as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_card(build)
    worst = phase_kernel_vs_plain(K, dev)
    filters = {n: mt.compile_file(str(ROOT / "filters" / "Distorts" / f"{n}.mm"))
               for n in FILTERS}
    launches = phase_main_path(mt, K, dev, filters)
    kernel_ms, plain_ms = phase_timings(mt, K, dev, filters, card)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "sample_image",
        "route": "cuda",
        "source": "mathmap_tpu_torch/csrc/sample_image.cu",
        "replaces": "mathmap_tpu/pallas_kernels/sample_kernel.py:741",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
