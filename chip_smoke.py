#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mathmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases, each printing its own lines:

1. card and build: the GPU's name and power limit (nvidia-smi), CUDA and
   torch versions; every kernel built by nvcc at once, one process per
   source, all started together: the library of mathmap_tpu_torch/csrc/*.cu
   (B1, B2, B4) and one generated while-loop kernel (B3) per distinct loop body
   of the phases below, traced from tiny CPU renders (nvcc seconds and
   ptxas register reports);
2. B1 vs plain: the CUDA origVal sampler against its plain PyTorch version
   on the same CUDA tensors, for every interpolation x edge pair x source
   dtype, at rtol=1e-4, atol=1e-5: at 1920x1080 and 3840x2160 (nearest
   and bilinear take the V = 4 instantiation, four pixels a thread;
   bicubic V = 1), at the ragged 1919x1081 and on 1920x1080 coordinate
   views offset by one element, not 16-byte aligned (all V = 1); each case
   prints its instantiation. Then a 256-value u8 ramp under nearest
   interpolation, bit for bit equal to u8_to_float, on both
   instantiations;
3. B2 vs plain: the LUT kernel against its plain version on the same CUDA
   tensors, (K,) and (K, 4) LUTs at K = 2, 256 and 5000 (shared- and
   global-memory routes), on 3840x2160 positions below 0, above 1, exactly
   0 and 1, and inside, at rtol=1e-5, atol=1e-6;
4. B3 vs plain: each loop's generated kernel against the eager masked loop
   on the same CUDA tensors: mandelbrot, julia, burning_ship, tricorn and
   biomorph at 3840x2160 (identical grids), a body with sin() and
   condition assignments at the default cap and at max_loop_iters=9
   (rtol=1e-4, atol=1e-5), mandelbrot at 13x100 and 2161x3839, and
   rand_walk (rand() in the body) at 3840x2160 after the unroll's first
   step, from the first iteration under seed 5, and at 2161x3839
   (identical);
5. distortion path: fisheye, twirl and pond through compile_file ->
   Filter.render(device="cuda") at 1920x1080 and 3840x2160; every render
   must launch the sampler kernel once, and the 1080p renders of a smooth
   seeded image must match the port's CPU renders (rtol=1e-4, atol=1e-5;
   uint8 output within 1 LSB);
6. generative path: mandelbrot (default and zoomed params, float32 and
   uint8 output) at 1920x1080 and 3840x2160, julia and burning_ship at
   3840x2160; every render must launch the loop kernel once and the LUT
   kernel once, and the 1080p renders must match the port's CPU renders
   (rtol=1e-4, atol=1e-5, differing pixels counted; uint8 within 1 LSB);
7. B4 vs plain: the tiled origVal sampler against its plain version on the
   same CUDA tensors at 3840x2160, on the blocks of a top, an interior and
   a bottom tile of a (1,4,1) mesh with halo 27, a corner tile of a (1,2,2)
   mesh with halo (27, 27) and a (1,1,1) mesh, probe and in-contract
   coordinates, every interpolation x edge pair, at rtol=1e-4, atol=1e-5
   and an equal excess;
8. tiled path: pond (default and amplitude=25) and ripple through
   Filter.render_tiled(halo="auto") at 3840x2160, u8 input on the card, on
   (1,4,1) and (1,2,2) meshes of the one card and the default make_mesh();
   every render must launch B4 once per tile and match the unsharded card
   render (rtol=1e-4, atol=1e-5, differing pixels counted); the 1080p tiled
   renders of a smooth image must match the port's CPU tiled render; a
   sample 40 rows away with halo 4 must raise;
9. sharded path: Filter.render_sharded of pond on (1,4,1) (one B1 launch
   per tile) and mandelbrot on (1,2,2) (one B3 and one B2 launch per tile)
   at 3840x2160, matching the unsharded card render;
10. timings on the card: median fenced render times (tiled pond 4K beside
   unsharded pond 4K), each kernel alone against its plain version and,
   where one PyTorch call computes the same function, against that call
   (grid_sample), and each kernel's bound. B1: all six cases (nearest,
   bilinear, bicubic on u8 and f32) at both sizes, with bound and share of
   bound, grid_sample of the same mode as yardstick for nearest and
   bilinear (none for bicubic: PyTorch's uses A = -0.75, B1's Catmull-Rom
   A = -0.5); then B1 on the coordinate fields that fisheye, twirl and pond
   hand it at 4K (u8 source, each interpolation), the main path's own
   traffic;
11. stochastic path (rand() and noise): the hash and perlin3 on the card
   against the CPU bit for bit (and what CUDA's float -> int conversion
   gives for NaN and inf); static_tv, film_grain, sparkle, dissolve,
   jitter, turbulence, clouds, voronoi, ridged_noise, hex_grid and
   rand_walk through Filter.render at 3840x2160, each render's B1, B2 and
   B3 launches counted (one B3 launch a rand_walk render), then at 480x270
   against the port's CPU render (bit for bit where only rand() and pixel-
   centre samples are involved); jitter and static_tv through
   render_tiled and render_sharded, and rand_walk through render_sharded,
   on (1,4,1) and (1,2,2) meshes of the card against the unsharded card
   render; last, the median 4K render times and B3 alone on rand_walk's
   loop against the eager loop, with its bound;
12. batch path at 3840x2160 through Filter.render_batch: 8 mandelbrot
   jobs with a list of param dicts (zoom 1 to 3 on the main cardioid's
   boundary, frames 0), one B3 and one B2 launch a job and no new build
   of the loop; twirl over one shared() u8 image at 8 angles with uint8
   output, one B1 launch a job; BASELINE config 5's traffic
   (benchmarks/run_configs.py, config 5): default mandelbrot and moire as
   an 8-frame t-sweep at t = (i + 0.37)/8, one B3 and one B2 launch a
   mandelbrot frame, none a moire frame; every job equal to its lone card
   render bit for bit;
13. animation path (BASELINE config 4, benchmarks/run_configs.py: "4x AA"
   is RenderOptions(supersample=2), a 2x2 grid of subsamples a pixel):
   ripple at 1920x1080 through Filter.render_animation(num_frames=120),
   one B1 launch a subsample of every frame; frames 0, 37 and 119 equal to
   render(t=..., frame=...) bit for bit, frame 37 against the CPU port,
   render_frames yielding the same frames;
14. animated inputs: an 8-frame 1080p u8 stack on the card; origVal(xy)
   returns each frame exactly, origValXY(x, y, 3) samples frame 3's view
   through B1 (held against its plain version); a warped per-pixel frame
   plane goes through the gather route (no kernel; no B1 launch) and is
   held against B1 on each frame it selects, chosen per pixel, and against
   the CPU render; NaN, ±inf, ±3e9 select the oracle's frame (0) on every
   route;
15. the mesh's frame axis: render_sharded(num_frames=4) of ripple over a
   4-frame stack on (4,1,1) and (2,2,1) meshes of the card against the
   lone renders, and the stack through render_tiled on (1,4,1), one B4
   launch a tile and frame, B4 on an animated block against its plain
   version.

Every main path (phases 5, 6, 8, 9, 11-15) runs with the four launch
counts set to 0 just before it and read just after; the kernels line
gives each kernel's launches by path. Then the timings: phase 10's and
11's, B3's bound (this run's pixel iterations x the distinct ops of an
iteration, integer ops at half rate, over the single-op issue rate SMs x
128 lanes x clocks.max.sm, with the loop's SASS instruction count beside
it), and the batches' ms a job and the animation's ms a frame beside their
lone renders.

Kernel times are CUDA events around a run of launches that the card starts
only after a sleep kernel, so the host has enqueued the run by then and the
events time the device, not the host's launch rate.

The line before the last is the JSON record of the kernels; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA GPU, or without the package beside this file, the script
exits non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
GENERATIVE = ("mandelbrot", "julia", "burning_ship", "tricorn", "biomorph")
#: mandelbrot zoomed onto the set's boundary
ZOOMED = {"maxiter": 256, "zoom": 3.0, "cx": -0.7435, "cy": 0.1314}
#: tests/test_language.py's engine body: sin(), a condition assignment
#: (n = n + 1 persists), values computed before the loop
SIN_BODY = ("filter sin_body ()"
            "  c = x / W + y / H;"
            "  z = 0; i = 0; n = 0;"
            "  while n = n + 1; z < 4 + c && i < 37 do"
            "    z = z + 0.2 + 0.1 * sin(c * 9 + i); i = i + 1 "
            "  end;"
            "  grayColor(clamp(z / 8 + i / 100 + n / 1000, 0, 1)) end")
#: a per-pixel trip count that draws rand(): its loop takes B3 after the
#: static unroll's first step
RAND_WALK = ("filter rand_walk () s = 0; i = 0;"
             "  while s < 1 && i < 64 do s = s + rand(0, 0.1) * (1 + x / W); i = i + 1 end;"
             "  grayColor(i / 64) end")
#: the stochastic path's renders: name -> (library folder, (B1, B2, B3)
#: launches a render); dissolve samples its two inputs in both branches
STOCHASTIC = {
    "static_tv": ("Noise", (1, 0, 0)), "film_grain": ("Noise", (1, 0, 0)),
    "sparkle": ("Noise", (1, 0, 0)), "dissolve": ("Combine", (2, 0, 0)),
    "jitter": ("Distorts", (1, 0, 0)), "turbulence": ("Noise", (0, 0, 0)),
    "clouds": ("Noise", (0, 0, 0)), "voronoi": ("Render", (0, 1, 0)),
    "ridged_noise": ("Noise", (0, 0, 0)), "hex_grid": ("Render", (0, 1, 0)),
    "rand_walk": (None, (0, 0, 1)),
}
#: drawn with rand() and elementwise ops, sampled at pixel centres only:
#: the card's render equals the CPU's bit for bit (the other stochastic
#: renders go through noise's libm-free ops but also sin, pow, sqrt or a
#: displaced sample, within RTOL, ATOL)
BIT_EXACT = ("static_tv", "film_grain", "sparkle", "dissolve", "rand_walk")
#: the card-vs-CPU comparison's size, so the CPU renders stay quick
REDUCED = (480, 270)
LUT_SIZES = (2, 256, 5000)
LUT_RTOL, LUT_ATOL = 1e-5, 1e-6
#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, fp32 (non-tensor)
#: op/s with an FMA counted as 2 (B1's operations bound)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: FP32 lanes an SM (4 schedulers, each issuing one 32-lane warp
#: instruction a clock): single ops (FADD, FMUL, a compare) an SM a clock
LANES_PER_SM = 128
#: clock cycles of the sleep before a timed run (~25 ms at 2 GHz): longer
#: than the host takes to queue one, so the events time back-to-back device
#: work (without it a 0.05 ms kernel times the host's launch rate)
SLEEP_CYCLES = 50_000_000


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


def probe_coordinates(w: int, h: int, seed: int, shape=None):
    """World-coordinate grids of a (w, h) frame in four row bands: in range,
    exact texel centres, far outside (±3·W), and within 3 px of an edge;
    (h, w) grids unless `shape` gives another (rows, cols)."""
    rs = np.random.RandomState(seed)
    rows, cols = shape or (h, w)
    x = np.empty((rows, cols), np.float32)
    y = np.empty((rows, cols), np.float32)
    bands = np.array_split(np.arange(rows), 4)
    n = [len(b) * cols for b in bands]
    x[bands[0]] = rs.uniform(-w / 2, w / 2, n[0]).reshape(-1, cols)
    y[bands[0]] = rs.uniform(-h / 2, h / 2, n[0]).reshape(-1, cols)
    x[bands[1]] = (rs.randint(0, w, n[1]) + 0.5 - w / 2).reshape(-1, cols)
    y[bands[1]] = (h / 2 - 0.5 - rs.randint(0, h, n[1])).reshape(-1, cols)
    x[bands[2]] = rs.uniform(-3 * w, 3 * w, n[2]).reshape(-1, cols)
    y[bands[2]] = rs.uniform(-3 * w, 3 * w, n[2]).reshape(-1, cols)
    ex = rs.choice([-w / 2, w / 2], n[3]) + rs.uniform(-3, 3, n[3])
    ey = rs.choice([-h / 2, h / 2], n[3]) + rs.uniform(-3, 3, n[3])
    x[bands[3]] = ex.reshape(-1, cols)
    y[bands[3]] = ey.reshape(-1, cols)
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
    """Mean device ms per call over `iters` calls, after a warm-up. The card
    sleeps first, so the host has queued the calls before the first runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def render_median_ms(f, img, dev, n: int = TIMED_RENDERS, **kw) -> float:
    """fenced_median_ms of Filter.render. `img` is None for a filter without
    an image input; `kw` goes to Filter.render (width, height, params)."""
    inputs = () if img is None else (img,)
    return fenced_median_ms(lambda: f.render(*inputs, device=dev, **kw), n)


def check_close(name, got, want, rtol=RTOL, atol=ATOL) -> float:
    err = (got - want).abs()
    if not bool(torch.all(err <= atol + rtol * want.abs())):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{float(err.max())} (rtol={rtol}, atol={atol})")
    return float(err.max())


def bound_ms(n_bytes: float, n_ops: float = 0.0, op_rate: float = FP32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over `op_rate` (default the fp32 rate,
    an FMA counted as 2) -> (ms, bound_by)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def single_op_rate() -> tuple:
    """The card's issue rate of single (not fused) 32-bit operations: SMs
    x LANES_PER_SM x the SM clock's maximum (nvidia-smi clocks.max.sm) ->
    (op/s, SMs, MHz). INT32 ops issue to a pipe of half that width."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * LANES_PER_SM * mhz * 1e6, sms, mhz


class LoopCapture:
    """Records every call of the evaluator's loop-kernel entry
    (runtime.tracer.loop_kernel) while active: (loop, flat0, mask0,
    max_iters, result)."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.calls = []

    def __enter__(self):
        self.orig = orig = self.tracer.loop_kernel

        def spy(loop, flat0, mask0, max_iters):
            out = orig(loop, flat0, mask0, max_iters)
            self.calls.append((loop, flat0, mask0, max_iters, out))
            return out

        self.tracer.loop_kernel = spy
        return self

    def __exit__(self, *exc):
        self.tracer.loop_kernel = self.orig

    def one(self, what: str):
        if len(self.calls) != 1:
            raise AssertionError(f"{what}: {len(self.calls)} loop-kernel calls, expected 1")
        return self.calls[0]


def ptxas_report(log: str):
    """One line per kernel of an `-Xptxas=-v` log: its name (demangled by
    cu++filt where the toolkit has it), registers and spills."""
    names, report, name, spill = [], {}, None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            names.append(name)
        elif name and "spill" in line:
            spill = line
        elif name and "registers" in line:
            report[name] = f"{line.split(':', 1)[1].strip()}; {spill}"
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    shown = dict(zip(names, names))
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            shown = dict(zip(names, out))
    return [f"{shown[n]}: {report[n]}" for n in names if n in report]


def phase_card(mt, build, WL, tracer, loop_filters):
    """The card, then every kernel built at once: the csrc/ library and one
    generated kernel per distinct loop body (traced on tiny CPU renders)."""
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    sources = {}
    with LoopCapture(tracer) as cap:
        for f, params in loop_filters:
            f.render(width=16, height=8, params=params, device="cpu")
    for loop, flat0, *_ in cap.calls:
        sources.setdefault(WL.emit_cuda(WL.trace(loop, len(flat0)), loop.origin), loop)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        lib = pool.submit(build.library)
        gens = [pool.submit(build.generated_library, src) for src in sources]
        lib = lib.result()
        gens = [g.result() for g in gens]
    print(f"nvcc: {len(sources) + 1} builds in parallel, {time.perf_counter() - t0:.2f} s wall")
    print(f"kernel library: {lib.path.relative_to(ROOT)} built by nvcc from "
          f"{build.CSRC.relative_to(ROOT)}/ in {lib.build_seconds:.2f} s")
    for line in ptxas_report(lib.log):
        print(f"  ptxas: {line}")
    for g, loop in zip(gens, sources.values()):
        print(f"generated loop kernel {g.path.name} (loop at {loop.origin}): nvcc "
              f"{g.build_seconds:.2f} s")
        for line in ptxas_report(g.log):
            print(f"  ptxas: {line}")
    return card


#: B1's cases against its plain version: (w, h), whether the coordinates
#: are views one element into their buffers, the pixels a thread expected
#: for nearest and bilinear (bicubic takes 1)
B1_CASES = (((1920, 1080), False, 4), ((3840, 2160), False, 4),
            ((1919, 1081), False, 1), ((1920, 1080), True, 1))


def offset_view(a):
    """A contiguous copy of `a` one element into a buffer of its own: the
    same values at an address 4 bytes past a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def instantiation(K, x, y, out, interpolation: str) -> int:
    """The pixels a thread the wrapper chose for a launch that wrote `out`."""
    return K.vector_width(int(x.shape[1]), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          interpolation)


def phase_kernel_vs_plain(K, dev) -> float:
    """At every shape of the main path, a ragged width and misaligned
    coordinate views: all interpolations x edge pairs x source dtypes; then
    the u8 ramp bit for bit."""
    worst = 0.0
    for seed, ((w, h), offset, want_vec) in enumerate(B1_CASES):
        f32, u8 = seeded_image(w, h, seed=1 + 2 * seed)
        srcs = {"f32": torch.from_numpy(f32).to(dev),
                "u8": torch.from_numpy(u8).to(dev)}
        x, y = (torch.from_numpy(a).to(dev)
                for a in probe_coordinates(w, h, seed=2 + 2 * seed))
        if offset:
            x, y = offset_view(x), offset_view(y)
        layout = "offset views" if offset else "aligned"
        for interp in INTERPOLATIONS:
            for ex, ey in EDGE_PAIRS:
                for dname, pix in srcs.items():
                    args = (pix, x, y, interp, ex, ey, EDGE_COLOR)
                    got = K.sample_image(*args)
                    want = K.sample_image_reference(*args)
                    torch.cuda.synchronize()
                    tag = f"{w}x{h} {layout} {interp} {ex}/{ey} {dname}"
                    err = check_close(tag, got, want)
                    vec = instantiation(K, x, y, got, interp)
                    expected = want_vec if interp in K.VECTOR_INTERPOLATIONS else 1
                    if vec != expected:
                        raise AssertionError(f"{tag}: V={vec}, expected V={expected}")
                    worst = max(worst, err)
                    print(f"kernel vs plain {w}x{h} {layout:12s} {interp:8s} "
                          f"{ex + '/' + ey:15s} {dname:3s} V={vec}: max abs err {err:.3e}")
    n = len(B1_CASES) * len(INTERPOLATIONS) * len(EDGE_PAIRS) * 2
    print(f"kernel vs plain: all {n} cases agree, worst max abs err {worst:.3e}")
    phase_u8_ramp(K, dev)
    return worst


def phase_u8_ramp(K, dev):
    """Every u8 value in every channel, sampled nearest at the texel
    centres: the kernel's three-operation conversion must give
    u8_to_float's bits (IEEE division by 255, on the CPU and on the card),
    on aligned (V = 4) and offset (V = 1) coordinate views."""
    hi, wi = 4, 64
    v = torch.arange(hi * wi).reshape(hi, wi, 1)
    ramp = ((v + 64 * torch.arange(4)) % 256).to(torch.uint8)
    want = K.u8_to_float(ramp).permute(2, 0, 1).contiguous()
    pix = ramp.to(dev)
    want_card = K.u8_to_float(pix).permute(2, 0, 1).cpu()
    xs = torch.arange(wi, dtype=torch.float32) + 0.5 - wi / 2
    ys = hi / 2 - (torch.arange(hi, dtype=torch.float32) + 0.5)
    x, y = (t.contiguous().to(dev) for t in torch.meshgrid(xs, ys, indexing="xy"))
    for views in ((x, y), (offset_view(x), offset_view(y))):
        got = K.sample_image(pix, *views, "nearest", "color", "color", EDGE_COLOR)
        vec = instantiation(K, *views, got, "nearest")
        bits = got.cpu().view(torch.int32)
        differ = int((bits != want.view(torch.int32)).sum())
        differ_card = int((bits != want_card.view(torch.int32)).sum())
        if differ or differ_card:
            raise AssertionError(f"u8 ramp V={vec}: {differ} values differ from the CPU's "
                                 f"u8/255, {differ_card} from the card's")
        print(f"u8 ramp (256 values x 4 channels) nearest V={vec}: bit for bit equal to "
              f"u8_to_float on the CPU and on the card")


def lut_positions(w: int, h: int, seed: int):
    """(h, w) LUT positions in four row bands: below 0, above 1, exactly 0
    or 1, and inside [0, 1]."""
    rs = np.random.RandomState(seed)
    pos = np.empty((h, w), np.float32)
    bands = np.array_split(np.arange(h), 4)
    pos[bands[0]] = rs.uniform(-2.0, 0.0, (len(bands[0]), w))
    pos[bands[1]] = rs.uniform(1.0, 3.0, (len(bands[1]), w))
    pos[bands[2]] = rs.choice([0.0, 1.0], (len(bands[2]), w))
    pos[bands[3]] = rs.uniform(0.0, 1.0, (len(bands[3]), w))
    return pos


def seeded_lut(k: int, channels: int, seed: int):
    shape = (k,) if channels == 1 else (k, channels)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def phase_lut_vs_plain(L, dev) -> float:
    """B2 against its plain version at the generative path's 4K shape."""
    w, h = SIZES[1]
    pos = torch.from_numpy(lut_positions(w, h, seed=6)).to(dev)
    worst = 0.0
    for k in LUT_SIZES:
        for channels in (1, 4):
            lut = torch.from_numpy(seeded_lut(k, channels, seed=k + channels)).to(dev)
            got = L.apply_lut(lut, pos)
            want = L.apply_lut_reference(lut, pos)
            torch.cuda.synchronize()
            err = check_close(f"apply_lut K={k} C={channels}", got, want,
                              rtol=LUT_RTOL, atol=LUT_ATOL)
            worst = max(worst, err)
            route = "shared" if k * channels * 4 <= 48 * 1024 else "global"
            print(f"B2 vs plain {w}x{h} K={k:5d} C={channels} ({route} LUT): "
                  f"max abs err {err:.3e}")
    print(f"B2 vs plain: all {2 * len(LUT_SIZES)} cases agree "
          f"(rtol={LUT_RTOL}, atol={LUT_ATOL}), worst max abs err {worst:.3e}")
    return worst


def loop_reference(WL, loop, flat0, mask0, max_iters):
    """The plain version on a captured loop's inputs -> (carry, steps,
    iterations): iterations counts every pixel's body evaluations."""
    active = []

    def counted(flat, mask, loop_i):
        active.append(mask.sum())
        return loop.step(flat, mask, loop_i)

    flat, steps = WL.while_loop_reference(counted, flat0, mask0, max_iters, loop.unroll,
                                          loop.it_base)
    return flat, steps, int(torch.stack(active).sum()) if active else 0


def phase_loop_vs_plain(mt, WL, tracer, dev, filters, sin_filter, rand_walk):
    """B3 against the eager masked loop on the same CUDA tensors -> (worst
    max abs err, worst of the rand_walk cases)."""
    cases = [(n, filters[n], *SIZES[1], None, True) for n in GENERATIVE]
    cases += [("sin body", sin_filter, *SIZES[1], None, False),
              ("sin body, max_loop_iters=9", sin_filter, *SIZES[1],
               mt.RenderOptions(max_loop_iters=9), False),
              ("mandelbrot", filters["mandelbrot"], 100, 13, None, True),
              ("mandelbrot", filters["mandelbrot"], 3839, 2161, None, True)]
    # rand() in the body: after the static unroll's first step (iterations
    # from 2), from iteration 1 under another seed, and on a ragged size
    cases += [("rand_walk", rand_walk, *SIZES[1], None, True),
              ("rand_walk, while_static_unroll=0, seed=5", rand_walk, *SIZES[1],
               mt.RenderOptions(while_static_unroll=0, seed=5), True),
              ("rand_walk", rand_walk, 3839, 2161, None, True)]
    worst = worst_rand = 0.0
    for name, f, w, h, opts, exact in cases:
        with LoopCapture(tracer) as cap:
            f.render(width=w, height=h, options=opts, device=dev)
        loop, flat0, mask0, max_iters, got = cap.one(name)
        want, steps, iters = loop_reference(WL, loop, flat0, mask0, max_iters)
        torch.cuda.synchronize()
        differ = sum(int(((a != b) & ~(a.isnan() & b.isnan())).sum())
                     for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        tag = f"B3 vs plain {name} {w}x{h}"
        if exact and differ:
            raise AssertionError(f"{tag}: {differ} carried values differ from the eager loop")
        if not exact:
            for a, b in zip(got, want):
                err = max(err, check_close(tag, a, b))
        worst = max(worst, err)
        if name.startswith("rand_walk"):
            worst_rand = max(worst_rand, err)
        print(f"{tag}: {len(flat0)} carried grids, {steps} eager steps from iteration "
              f"{loop.it_base + 1}, {iters} pixel iterations; {differ} values differ, max "
              f"abs err {err:.3e} "
              f"({'identical required' if exact else f'rtol={RTOL}, atol={ATOL}'})")
    print(f"B3 vs plain: all {len(cases)} cases agree, worst max abs err {worst:.3e}")
    return worst, worst_rand


def phase_distortion_path(mt, K, dev, filters):
    """Every render goes through the sampler kernel; 1080p matches the CPU
    port."""
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
                    print(f"distortion path {tag}: ok")
                    continue
                cpu_img = img.cpu()
                ref = f.render(cpu_img, params=params, options=opts, device="cpu")
                if out_dtype == "uint8":
                    lsb = int((out.cpu().int() - ref.int()).abs().max())
                    if lsb > 1:
                        raise AssertionError(f"{tag}: {lsb} LSB from the CPU render")
                    print(f"distortion path {tag}: max {lsb} LSB from the CPU render")
                else:
                    err = check_close(tag, out.cpu(), ref)
                    print(f"distortion path {tag}: max abs err {err:.3e} vs the CPU render")
    launches = K.sample_image.launches
    if launches != renders:
        raise AssertionError(f"{launches} sampler launches for {renders} renders")
    print(f"distortion path: {renders} GPU renders, {launches} sampler kernel launches")
    return launches


def grid_sample_image(pix, x, y, mode: str = "bilinear"):
    """B1's function as one PyTorch call: grid_sample (`mode` "bilinear" or
    "nearest") with zero padding (the transparent edge color) on the
    float32 NCHW copy of `pix`; returns (call, its (4, H, W) output). The
    layout copy and the normalised grid are made here, outside the timed
    call."""
    import torch.nn.functional as F

    hi, wi = pix.shape[:2]
    src = pix.float() / 255.0 if pix.dtype == torch.uint8 else pix
    img = src.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([x * (2.0 / wi), y * (-2.0 / hi)], dim=-1)[None]

    def call():
        return F.grid_sample(img, grid, mode=mode, padding_mode="zeros",
                             align_corners=False)

    return call, call()[0]


def grid_sample_lut(lut, pos):
    """B2's function as one PyTorch call: the LUT as a (1, C, 1, K) image,
    bilinear grid_sample with align_corners=True and border padding (the
    clamp to [0, 1]); returns (call, its (C, H, W) output)."""
    import torch.nn.functional as F

    k = lut.shape[0]
    img = lut.reshape(k, -1).t().reshape(1, -1, 1, k).contiguous()
    grid = torch.stack([pos * 2.0 - 1.0, torch.zeros_like(pos)], dim=-1)[None]

    def call():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    return call, call()[0]


def turns(plain, kernel, n_plain: int, n_kernel: int):
    """(kernel ms, plain ms): timed plain, kernel, kernel, plain."""
    runs = [event_ms(plain, n_plain), event_ms(kernel, n_kernel),
            event_ms(kernel, n_kernel), event_ms(plain, n_plain)]
    return (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2


#: the grid_sample mode that computes each of B1's interpolations, its
#: yardstick; none computes B1's bicubic
GRID_SAMPLE_MODE = {"nearest": "nearest", "bilinear": "bilinear", "bicubic": None}
NO_BICUBIC_YARDSTICK = ("no yardstick: PyTorch's bicubic is the cubic convolution "
                        "with A = -0.75, B1's Catmull-Rom has A = -0.5")


def b1_ops(interp: str, u8: bool) -> int:
    """fp32 operations per output pixel of B1, an FMA counted as 2: pixel
    centres, taps and fractions, the interpolation's weights and its
    arithmetic on 4 channels, and 3 per channel and tap for the u8
    conversion."""
    taps, ops = {"nearest": (1, 4), "bilinear": (4, 42), "bicubic": (16, 184)}[interp]
    return ops + (taps * 4 * 3 if u8 else 0)


def b1_inputs(w: int, h: int, dev):
    """The timed cases' inputs: a seeded u8 image, its f32 copy (u8/255)
    and the smooth warp's coordinates."""
    _, u8 = seeded_image(w, h, seed=4)
    img = torch.from_numpy(u8).to(dev)
    x, y = smooth_warp(w, h, dev)
    return {"u8": img, "f32": (img.float() / 255.0).contiguous()}, x, y


def time_b1_case(K, label: str, args, lib_bilinear: float, card, with_plain: bool):
    """B1 on `args` (sample_image's): its time (in turns with the plain
    version when `with_plain`), its bound and share of bound, the
    grid_sample yardstick of the same mode, and the time over
    `lib_bilinear`, the bilinear grid_sample of the same inputs (the ratio
    that compares calls on different cards). Prints one line, returns the
    record."""
    pix, x, y, interp = args[:4]

    def kernel():
        return K.sample_image(*args)

    if with_plain:
        kernel_ms, plain_ms = turns(lambda: K.sample_image_reference(*args), kernel, 5, 50)
    else:
        kernel_ms, plain_ms = (event_ms(kernel, 50) + event_ms(kernel, 50)) / 2, None
    got = kernel()
    err = check_close(f"timed {label} {interp}", got, K.sample_image_reference(*args))
    n_bytes = (x.numel() + y.numel()) * 4 + got.numel() * 4 + pix.numel() * pix.element_size()
    bound, by = bound_ms(n_bytes, b1_ops(interp, pix.dtype == torch.uint8) * x.numel())
    # a checkout from before V = 4 has no vector_width
    vector_width = getattr(K, "vector_width", None)
    vec = vector_width(int(x.shape[1]), x.data_ptr(), y.data_ptr(), got.data_ptr(), interp) \
        if vector_width else None
    line = (f"timing {label} {interp:8s}{f' V={vec}' if vec else ''}: kernel "
            f"{kernel_ms:.4f} ms, bound {bound:.4f} ms ({n_bytes / 1e6:.0f} MB, {by}), "
            f"{100 * bound / kernel_ms:.1f}% of bound")
    if plain_ms is not None:
        line += f", plain {plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x)"
    line += f", max abs err {err:.3e}; "
    mode, lib_ms = GRID_SAMPLE_MODE[interp], None
    if mode:
        lib, lib_out = grid_sample_image(pix, x, y, mode)
        lib_ms = lib_bilinear if mode == "bilinear" else event_ms(lib, 50)
        line += (f"grid_sample {mode} {lib_ms:.4f} ms (max abs diff "
                 f"{float((lib_out - got).abs().max()):.2e})")
    else:
        line += NO_BICUBIC_YARDSTICK
    line += (f"; kernel / grid_sample bilinear {lib_bilinear:.4f} ms = "
             f"{kernel_ms / lib_bilinear:.3f}")
    print(f"{line} [{card}]")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, vec=vec)


def time_b1(K, dev, card, sizes=SIZES, with_plain: bool = True):
    """B1 alone in its six cases (nearest, bilinear, bicubic on u8 and f32)
    on the smooth warp at each size, the renders' transparent color edge
    (grid_sample's zero padding). Returns {(w, h, dtype, interp): record}."""
    records = {}
    for (w, h) in sizes:
        srcs, x, y = b1_inputs(w, h, dev)
        for dname, pix in srcs.items():
            lib_bilinear = event_ms(grid_sample_image(pix, x, y)[0], 50)
            for interp in INTERPOLATIONS:
                args = (pix, x, y, interp, "color", "color", (0.0, 0.0, 0.0, 0.0))
                records[(w, h, dname, interp)] = time_b1_case(
                    K, f"B1 {w}x{h} {dname:3s}", args, lib_bilinear, card, with_plain)
    return records


def time_b1_fields(K, sampling, dev, filters, card):
    """B1 on the main path's own traffic: the coordinate fields that
    fisheye, twirl and pond at their default params hand the sampler at
    3840x2160 on a seeded u8 image, with the render's edges, at each
    interpolation. Returns {(filter, interp): record}."""
    w, h = SIZES[1]
    _, u8 = seeded_image(w, h, seed=4)
    img = torch.from_numpy(u8).to(dev)
    records = {}
    for name in FILTERS:
        with KernelCapture(sampling, "sample_kernel") as cap:
            filters[name].render(img, device=dev)
        (pix, x, y, _, ex, ey, col), _ = cap.calls[0]
        lib_bilinear = event_ms(grid_sample_image(pix, x, y)[0], 50)
        for interp in INTERPOLATIONS:
            records[(name, interp)] = time_b1_case(
                K, f"B1 {name:7s} field {w}x{h} u8", (pix, x, y, interp, ex, ey, col),
                lib_bilinear, card, with_plain=False)
    return records


def phase_timings(mt, K, sampling, dev, filters, card):
    """Fenced render medians, and B1 alone vs its plain version and vs
    grid_sample, on the smooth warp and on the renders' coordinate fields;
    returns B1's record at 4K u8 bilinear on the smooth warp, with the f32
    bilinear and u8 bicubic times beside it."""
    for (w, h) in SIZES:
        _, u8 = seeded_image(w, h, seed=4)
        img = torch.from_numpy(u8).to(dev)
        for name in FILTERS:
            ms = render_median_ms(filters[name], img, dev)
            print(f"timing render {name:7s} {w}x{h} u8 in: median {ms:.3f} "
                  f"ms/frame of {TIMED_RENDERS}, {w * h / ms / 1e3:.1f} Mpix/s "
                  f"[{card}]")
    records = time_b1(K, dev, card)
    time_b1_fields(K, sampling, dev, filters, card)
    w, h = SIZES[1]
    record = dict(records[(w, h, "u8", "bilinear")])
    vec = record.pop("vec")
    record.update(f32_ms=records[(w, h, "f32", "bilinear")]["ms"],
                  bicubic_u8_ms=records[(w, h, "u8", "bicubic")]["ms"],
                  instantiation=f"sample_image_kernel<uchar4, bilinear, V={vec}>")
    return record


def phase_generative_path(mt, L, WL, dev, filters):
    """Every render launches the loop kernel once and the LUT kernel once;
    1080p matches the CPU port."""
    from mathmap_tpu_torch.runtime.render import pack_uint8

    L.apply_lut.launches = 0
    WL.while_loop.launches = 0
    renders = 0
    cpu = {}
    for (w, h) in SIZES:
        cases = [(n, p, o) for n, p in (("mandelbrot", {}), ("mandelbrot", ZOOMED))
                 for o in ("float32", "uint8")]
        if (w, h) == SIZES[1]:
            cases += [("julia", {}, "float32"), ("burning_ship", {}, "float32")]
        for name, params, out_dtype in cases:
            opts = mt.RenderOptions(output_dtype=out_dtype)
            before = (L.apply_lut.launches, WL.while_loop.launches)
            out = filters[name].render(width=w, height=h, params=params,
                                       options=opts, device=dev)
            torch.cuda.synchronize()
            renders += 1
            counts = (L.apply_lut.launches - before[0], WL.while_loop.launches - before[1])
            tag = (f"{name:12s} {w}x{h} {out_dtype:7s} out, "
                   f"{'default' if not params else 'zoomed'} params")
            if counts != (1, 1):
                raise AssertionError(f"{tag}: {counts} LUT and loop kernel launches, "
                                     f"expected 1 each")
            if tuple(out.shape) != (h, w, 4) or out.device != dev:
                raise AssertionError(f"{tag}: bad output {tuple(out.shape)} on {out.device}")
            if out_dtype == "float32" and not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{tag}: non-finite output")
            if (w, h) != SIZES[0]:
                print(f"generative path {tag}: ok")
                continue
            key = (name, tuple(sorted(params.items())))
            if key not in cpu:
                cpu[key] = filters[name].render(width=w, height=h, params=params,
                                                device="cpu")
            ref = cpu[key]
            got = out.cpu()
            if out_dtype == "uint8":
                diff = (got.int() - pack_uint8(ref).int()).abs()
                lsb = int(diff.max())
                n_px = int((diff > 0).any(-1).sum())
                if lsb > 1:
                    raise AssertionError(f"{tag}: {lsb} LSB from the CPU render")
                print(f"generative path {tag}: max {lsb} LSB from the CPU render, "
                      f"{n_px} pixels differ")
            else:
                err = check_close(tag, got, ref)
                n_px = int(((got - ref).abs() > 0).any(-1).sum())
                print(f"generative path {tag}: max abs err {err:.3e} vs the CPU "
                      f"render, {n_px} pixels differ")
    counts = (L.apply_lut.launches, WL.while_loop.launches)
    if counts != (renders, renders):
        raise AssertionError(f"{counts} LUT and loop kernel launches for {renders} renders")
    print(f"generative path: {renders} GPU renders, {counts[0]} LUT kernel launches, "
          f"{counts[1]} loop kernel launches")
    return counts


def loop_sass(WL, build, prog, loop) -> str:
    """The loop's machine code in the generated library: the SASS
    instructions from the loop's label to its back branch (cuobjdump
    -sass; the longest backward branch of while_loop_kernel), the branches
    out of it and its most frequent opcodes. One pass from the label to
    the back branch is one iteration unless nvcc unrolled the loop, which
    the exits show (one exit test an iteration)."""
    lib = build.generated_library(WL.emit_cuda(prog, loop.origin))
    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).parent / "cuobjdump")
    try:
        dump = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"SASS not read: {e}"
    instrs, labels, inside = [], {}, False
    pending = []
    for line in dump.splitlines():
        if "Function :" in line:
            inside = "while_loop_kernel" in line
            continue
        if not inside:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instrs.append((addr, m.group(2)))

    def target(text):
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if not m:
            return None
        return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)

    back = [(target(t), a) for a, t in instrs if target(t) is not None and target(t) <= a]
    if not back:
        return f"SASS: no backward branch among {len(instrs)} instructions"
    lo, hi = max(back, key=lambda b: b[1] - b[0])
    body = [t for a, t in instrs if lo <= a <= hi]
    exits = sum(1 for t in body if "EXIT" in t or (
        target(t) is not None and not lo <= target(t) <= hi))
    ops = {}
    for t in body:
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8])
    return (f"SASS: {len(body)} instructions from the loop's label to its back branch, "
            f"{exits} branches out of it; {top}")


def time_b3(WL, build, tracer, render, label: str, card, rate: float, sass: dict):
    """B3 alone on the loop that `render()` launches: kernel and eager loop
    in turns on the captured inputs, identical outputs, and the bound.
    Operations: this run's pixel iterations x the issue slots of one, at
    `rate` single ops a second (the generated bodies are built with
    --fmad=false, so every op is one FADD, FMUL, compare or integer
    instruction): an iteration takes the larger of its distinct ops
    (Program.n_distinct_ops, a rand() draw counted as its hash's
    RAND_OPS) and twice its integer ops (a draw's RAND_INT_OPS, which issue
    to the INT32 pipe, half as wide). Bytes: the carried and dependency
    grids read once, a broadcast one by its distinct values, and the
    outputs written once. Prints the loop's SASS once per loop (`sass`
    remembers them) and one line; returns the record."""
    with LoopCapture(tracer) as cap:
        render()
    loop, flat0, mask0, max_iters, got = cap.one(label)
    h, w = mask0.shape
    prog = WL.trace(loop, len(flat0))
    want, steps, iters = loop_reference(WL, loop, flat0, mask0, max_iters)
    kernel_ms, plain_ms = turns(
        lambda: WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                        loop.it_base),
        lambda: WL.while_loop(loop, flat0, mask0, max_iters), 2, 20)
    values = {("carry", k): a for k, a in enumerate(flat0)}
    values.update({("x",): loop.x, ("y",): loop.y})
    values.update({("dep", n, j): a for n, tv in loop.deps for j, a in enumerate(tv.arrays)})
    n_bytes = mask0.numel() + 4 * sum(a.numel() for a in got)
    for key in prog.grid_inputs:
        a = values[key]
        if a.dim() == 2:
            n_bytes += 4 * (a.shape[0] if a.stride(0) else 1) * (a.shape[1] if a.stride(1) else 1)
        else:
            n_bytes += 4
    n_rand = sum(op == "rand" for op, _, _ in prog.ops)
    distinct, n_int = prog.n_distinct_ops(), n_rand * WL.RAND_INT_OPS
    slots = max(distinct, 2 * n_int)
    n_ops = iters * slots
    bound, by = bound_ms(n_bytes, n_ops, rate)
    same = all(torch.equal(a, b) for a, b in zip(WL.while_loop(loop, flat0, mask0, max_iters), want))
    source = WL.emit_cuda(prog, loop.origin)
    if source not in sass:
        sass[source] = loop_sass(WL, build, prog, loop)
        print(f"B3 loop at {loop.origin} ({label}): {prog.n_compute_ops()} ops in the op "
              f"list, {distinct} distinct ({n_rand} rand draws of {WL.RAND_OPS}, "
              f"{WL.RAND_INT_OPS} of them integer); {sass[source]}")
    print(f"timing B3 {label}: kernel {kernel_ms:.4f} ms, eager "
          f"loop {plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x), identical {same}; "
          f"{iters} pixel iterations in the kernel ({iters / (w * h):.2f} per "
          f"pixel, {steps} steps) + {loop.it_base * w * h} unrolled before it; "
          f"{distinct} distinct ops each ({prog.n_compute_ops()} listed), {n_int} integer, "
          f"{slots} issue slots = {n_ops / 1e9:.3f} G at {rate / 1e12:.2f}e12 op/s; "
          f"{n_bytes / 1e6:.0f} MB; bound {bound:.4f} ms ({by}), "
          f"{100 * bound / kernel_ms:.1f}% of bound [{card}]")
    if not same:
        raise AssertionError(f"timed B3 {label}: output differs from the eager loop")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)


def phase_generative_timings(mt, L, WL, build, tracer, dev, filters, card, rate, sass):
    """Mandelbrot render medians; B3 and B2 alone at 4K against their plain
    versions (and B2 against grid_sample), with their bounds (B3's at
    `rate`, see time_b3)."""
    f = filters["mandelbrot"]
    for (w, h) in SIZES:
        for label, params in (("default", {}), ("zoomed", ZOOMED)):
            ms = render_median_ms(f, None, dev, width=w, height=h, params=params)
            print(f"timing render mandelbrot {w}x{h} {label} params: median "
                  f"{ms:.3f} ms/frame of {TIMED_RENDERS}, {w * h / ms / 1e3:.1f} "
                  f"Mpix/s [{card}]")
    w, h = SIZES[1]
    records = {label: time_b3(WL, build, tracer, lambda p=params: f.render(
        width=w, height=h, params=p, device=dev), f"mandelbrot {w}x{h} {label}", card,
        rate, sass)
        for label, params in (("default", {}), ("zoomed", ZOOMED))}
    # B2 at the render's shape and LUT size: (256, 4) gradient, 4K positions
    pos = torch.from_numpy(np.random.RandomState(8).rand(h, w).astype(np.float32)).to(dev)
    lut = torch.from_numpy(seeded_lut(256, 4, seed=9)).to(dev)
    kernel_ms, plain_ms = turns(lambda: L.apply_lut_reference(lut, pos),
                                lambda: L.apply_lut(lut, pos), 5, 50)
    got = L.apply_lut(lut, pos)
    err = check_close("timed B2", got, L.apply_lut_reference(lut, pos),
                      rtol=LUT_RTOL, atol=LUT_ATOL)
    lib, lib_out = grid_sample_lut(lut, pos)
    lib_ms = event_ms(lib, 50)
    n_bytes = pos.numel() * 4 + got.numel() * 4 + lut.numel() * 4
    bound, by = bound_ms(n_bytes)
    print(f"timing B2 {w}x{h} K=256 C=4: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x), max abs err {err:.3e}; "
          f"grid_sample {lib_ms:.4f} ms (max abs diff "
          f"{float((lib_out - got).abs().max()):.2e}); bound {bound:.4f} ms "
          f"({n_bytes / 1e6:.0f} MB) [{card}]")
    records["lut"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
    return records


#: kernel B4's cases at 4K: (label, mesh rows, mesh cols, halo rows, halo
#: cols, the tile's row, the tile's col)
TILED_CASES = (("(1,4,1) top", 4, 1, 27, 0, 0, 0), ("(1,4,1) interior", 4, 1, 27, 0, 1, 0),
               ("(1,4,1) bottom", 4, 1, 27, 0, 3, 0), ("(1,2,2) corner", 2, 2, 27, 27, 0, 1),
               ("(1,1,1)", 1, 1, 27, 0, 0, 0))
#: the tiled path's renders at 4K, each on every mesh of TILED_MESHES
TILED_FILTERS = (("pond", {}), ("pond", {"amplitude": 25.0}), ("ripple", {}))
#: meshes of the one card; None = make_mesh(), every visible GPU on the rows
TILED_MESHES = ((1, 4, 1), (1, 2, 2), None)


def card_mesh(mt, dev, shape):
    if shape is None:
        return mt.make_mesh()
    return mt.make_mesh(*shape, devices=[dev] * int(np.prod(shape)))


def tiled_block(img, th: int, tw: int, hy: int, hx: int, r: int, c: int, nx: int):
    """The halo-extended block tile (r, c) holds after the ring exchange:
    its rows (and cols, when split) plus the halo, wrapping at the frame's
    edges."""
    gh, gw = img.shape[:2]
    rows = torch.arange(r * th - hy, (r + 1) * th + hy, device=img.device) % gh
    cols = (torch.arange(c * tw - hx, (c + 1) * tw + hx, device=img.device) % gw
            if nx > 1 else torch.arange(gw, device=img.device))
    return img[rows][:, cols].contiguous()


def contract_coordinates(w: int, h: int, th: int, tw: int, r: int, c: int,
                         hy: int, hx: int, seed: int):
    """World coordinates of tile (r, c)'s pixel centres displaced by up to
    its halo less the bicubic margin of 3 (±20 px across an axis that is
    not split, hx == 0)."""
    rs = np.random.RandomState(seed)
    x = (np.arange(c * tw, (c + 1) * tw)[None, :] + 0.5 - w / 2) \
        + rs.uniform(-1, 1, (th, tw)) * (hx - 3 if hx else 20)
    y = (h / 2 - 0.5 - np.arange(r * th, (r + 1) * th)[:, None]) \
        + rs.uniform(-1, 1, (th, tw)) * (hy - 3)
    return x.astype(np.float32), y.astype(np.float32)


def phase_tiled_vs_plain(B4, dev) -> float:
    """B4 against its plain version on the blocks of a top, an interior and
    a bottom tile of a (1,4,1) mesh, a corner tile of a (1,2,2) mesh and a
    (1,1,1) mesh at 4K: probe coordinates (mostly far out of the halo) and
    in-contract ones, every interpolation x edge pair; equal excess."""
    gw, gh = SIZES[1]
    f32, _ = seeded_image(gw, gh, seed=11)
    img = torch.from_numpy(f32).to(dev)
    worst, n = 0.0, 0
    for k, (label, ny, nx, hy, hx, r, c) in enumerate(TILED_CASES):
        th, tw = gh // ny, gw // nx
        hx = hx if nx > 1 else 0
        ext = tiled_block(img, th, tw, hy, hx, r, c, nx)
        geom = dict(gh=gh, gw=gw, row_base=r * th - hy, col_base=c * tw - hx,
                    col_sharded=nx > 1, edge_color=EDGE_COLOR)
        coord_sets = {"probe": probe_coordinates(gw, gh, seed=20 + k, shape=(th, tw)),
                      "in-contract": contract_coordinates(gw, gh, th, tw, r, c, hy, hx,
                                                          seed=30 + k)}
        for cname, (xn, yn) in coord_sets.items():
            x, y = torch.from_numpy(xn).to(dev), torch.from_numpy(yn).to(dev)
            errs, excesses = [], set()
            for interp in INTERPOLATIONS:
                for ex, ey in EDGE_PAIRS:
                    kw = dict(geom, interpolation=interp, edge_x=ex, edge_y=ey)
                    got, e_got = B4.sample_tiled(ext, x, y, **kw)
                    want, e_want = B4.sample_tiled_reference(ext, x, y, **kw)
                    torch.cuda.synchronize()
                    tag = f"B4 {label} {cname} {interp} {ex}/{ey}"
                    errs.append(check_close(tag, got, want))
                    if int(e_got) != int(e_want):
                        raise AssertionError(f"{tag}: excess {int(e_got)} != plain {int(e_want)}")
                    if cname == "in-contract" and int(e_got) > 0:
                        raise AssertionError(f"{tag}: in-contract taps reached {int(e_got)} "
                                             f"past the block")
                    excesses.add(int(e_got))
                    n += 1
            worst = max(worst, max(errs))
            print(f"B4 vs plain {gw}x{gh} {label:16s} block {tuple(ext.shape[:2])} "
                  f"{cname:11s}: 15 cases, max abs err {max(errs):.3e}, excess "
                  f"{min(excesses)}..{max(excesses)} (equal)")
    print(f"B4 vs plain: all {n} cases agree (rtol={RTOL}, atol={ATOL}, equal excess), "
          f"worst max abs err {worst:.3e}")
    return worst


def phase_tiled_path(mt, B4, dev, filters):
    """render_tiled of pond and ripple at 4K on every mesh of the one card:
    one B4 launch per tile, the unsharded card render's values; the 1080p
    tiled renders of a smooth image against the port's CPU tiled render; a
    sample past the halo raises."""
    B4.sample_tiled.launches = 0
    renders = 0
    gw, gh = SIZES[1]
    _, u8 = seeded_image(gw, gh, seed=12)
    img = torch.from_numpy(u8).to(dev)
    for name, params in TILED_FILTERS:
        f = filters[name]
        want = f.render(img, params=params, t=0.3, device=dev)
        for shape in TILED_MESHES:
            mesh = card_mesh(mt, dev, shape)
            before = B4.sample_tiled.launches
            out = f.render_tiled(img, mesh=mesh, params=params, t=0.3)
            torch.cuda.synchronize()
            renders += 1
            tiles = mesh.devices.size
            tag = (f"tiled {name:6s} {'default' if not params else 'amplitude=25'} "
                   f"{gw}x{gh} u8 in, mesh {tuple(mesh.devices.shape)}")
            if B4.sample_tiled.launches - before != tiles:
                raise AssertionError(f"{tag}: {B4.sample_tiled.launches - before} B4 "
                                     f"launches for {tiles} tiles")
            if tuple(out.shape) != (gh, gw, 4) or out.device != want.device:
                raise AssertionError(f"{tag}: bad output {tuple(out.shape)} on {out.device}")
            err = check_close(tag, out, want)
            n_px = int(((out - want).abs() > 0).any(-1).sum())
            print(f"tiled path {tag}: {tiles} B4 launches, max abs err {err:.3e} vs the "
                  f"unsharded card render, {n_px} pixels differ")
    w1, h1 = SIZES[0]
    _, su8 = smooth_image(w1, h1, seed=13)
    sdev = torch.from_numpy(su8).to(dev)
    for name in ("pond", "ripple"):
        for shape in TILED_MESHES[:2]:
            n_dev = int(np.prod(shape))
            out = filters[name].render_tiled(sdev, mesh=card_mesh(mt, dev, shape), t=0.3)
            torch.cuda.synchronize()
            renders += 1
            ref = filters[name].render_tiled(
                su8, mesh=mt.make_mesh(*shape, devices=["cpu"] * n_dev), t=0.3)
            tag = f"tiled {name:6s} {w1}x{h1} smooth u8 in, mesh {shape}"
            err = check_close(tag, out.cpu(), ref)
            n_px = int(((out.cpu() - ref).abs() > 0).any(-1).sum())
            print(f"tiled path {tag}: max abs err {err:.3e} vs the CPU tiled render, "
                  f"{n_px} pixels differ")
    launches = B4.sample_tiled.launches
    try:
        mt.compile_source("origVal(xy + xy:[0, 40])").render_tiled(
            img, halo=4, mesh=card_mesh(mt, dev, (1, 4, 1)))
    except mt.MMRuntimeError as e:
        print(f"tiled path: a sample 40 rows away with halo 4 raises: {e}")
    else:
        raise AssertionError("a sample past the halo did not raise")
    print(f"tiled path: {renders} GPU renders, {launches} B4 launches")
    return launches


def phase_sharded_path(mt, K, L, WL, dev, filters):
    """render_sharded of pond on (1,4,1) and mandelbrot on (1,2,2) at 4K:
    one B1 (pond) or one B3 and one B2 (mandelbrot) launch per tile, the
    unsharded card render's values."""
    gw, gh = SIZES[1]
    _, u8 = seeded_image(gw, gh, seed=14)
    img = torch.from_numpy(u8).to(dev)
    cases = (("pond", (img,), (1, 4, 1), {}), ("mandelbrot", (), (1, 2, 2),
                                                dict(width=gw, height=gh)))
    for name, inputs, shape, size in cases:
        f = filters[name]
        want = f.render(*inputs, device=dev, **size)
        before = (K.sample_image.launches, L.apply_lut.launches, WL.while_loop.launches)
        out = f.render_sharded(*inputs, mesh=card_mesh(mt, dev, shape), **size)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(
            (K.sample_image.launches, L.apply_lut.launches, WL.while_loop.launches), before))
        expected = (4, 0, 0) if name == "pond" else (0, 4, 4)
        tag = f"sharded {name} {gw}x{gh} mesh {shape}"
        if counts != expected:
            raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}, expected {expected}")
        err = check_close(tag, out, want)
        n_px = int(((out - want).abs() > 0).any(-1).sum())
        print(f"sharded path {tag}: (B1, B2, B3) launches {counts}, max abs err {err:.3e} "
              f"vs the unsharded card render, {n_px} pixels differ")


def launch_counts(*wrappers) -> tuple:
    return tuple(w.launches for w in wrappers)


def stochastic_inputs(f, w: int, h: int, dev, seed: int) -> list:
    """Seeded u8 images on `dev`, one per image parameter of `f`."""
    n = sum(1 for p in f.fdef.params if p.kind == "image")
    return [torch.from_numpy(seeded_image(w, h, seed=seed + i)[1]).to(dev) for i in range(n)]


def phase_rand_noise_vs_cpu(dev):
    """rand()'s hash and perlin3 on the card against the CPU, bit for bit:
    the hash at 4K under four salts, loop salts up to 2^32 - 1 among them;
    perlin3 on random, negative, lattice, large (above 2^24 and 2^31),
    NaN and infinite coordinates (NaN where the CPU has NaN). Prints what
    CUDA's own float -> int32 conversion gives where NumPy's gives
    INT_MIN, and the lattice index the port takes there."""
    from mathmap_tpu_torch.ops import noise as N
    from mathmap_tpu_torch.ops import rand as RND

    w, h = SIZES[1]
    salts = ((RND.draw_salt(0, 1), None), (RND.draw_salt(7, 1000003 * 3 + 2), 9),
             (0xFFFFFFFF, 0xFFFFFFFF), (0x80000000, 2**31))
    for salt, extra in salts:
        got = RND.rand_uniform(RND.rand_index((h, w), w, 0, 0, dev), salt, extra)
        want = RND.rand_uniform(RND.rand_index((h, w), w, 0, 0, "cpu"), salt, extra)
        if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"rand hash, salt {salt:#x}, loop salt {extra}: the card "
                                 f"differs from the CPU")
    print(f"rand hash {w}x{h}: {len(salts)} salts, the card equals the CPU bit for bit")
    rs = np.random.RandomState(3)
    special = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0**31, 2.0**31 - 128, 1e20],
                       np.float32)
    n = 1 << 20
    coords = np.concatenate([
        rs.uniform(-300, 300, (3, n)), rs.randint(-600, 600, (3, 4096)),
        rs.choice([-1, 1], (3, 4096)) * rs.uniform(2**24, 2**40, (3, 4096)),
        np.stack([np.resize(special, 4096), rs.uniform(-9, 9, 4096), rs.uniform(-9, 9, 4096)]),
    ], axis=1).astype(np.float32)
    cpu = [torch.from_numpy(c) for c in coords]
    want = N.perlin3(*cpu)
    got = N.perlin3(*(c.to(dev) for c in cpu)).cpu()
    nan = want.isnan()
    if not (torch.equal(got.isnan(), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
        raise AssertionError("perlin3: the card differs from the CPU")
    with np.errstate(invalid="ignore"):
        numpy_index = (special.astype(np.int32) & 255).tolist()
    sdev = torch.from_numpy(special).to(dev)
    print(f"perlin3 on {coords.shape[1]} points (random, lattice, large, NaN, inf): the card "
          f"equals the CPU bit for bit, {int(nan.sum())} NaN on both")
    print(f"lattice index of {special.tolist()}: NumPy on x86 {numpy_index}; the card's "
          f"float -> int32 conversion & 255: {(sdev.to(torch.int32) & 255).cpu().tolist()}; "
          f"noise.lattice on the card: {N.lattice(sdev).cpu().tolist()}")


def phase_stochastic_path(mt, K, L, WL, dev, st) -> int:
    """The stochastic slice through Filter.render at 3840x2160: each
    render's (B1, B2, B3) launches as STOCHASTIC says, finite output of the
    frame's shape; then each at REDUCED size against the port's CPU render,
    bit for bit for BIT_EXACT, within RTOL, ATOL for the others, differing
    pixels counted. Returns B3's launches in the 4K renders."""
    K.sample_image.launches = L.apply_lut.launches = WL.while_loop.launches = 0
    wrappers = (K.sample_image, L.apply_lut, WL.while_loop)
    w, h = SIZES[1]
    for name, (_, expected) in STOCHASTIC.items():
        inputs = stochastic_inputs(st[name], w, h, dev, seed=40)
        before = launch_counts(*wrappers)
        out = st[name].render(*inputs, width=w, height=h, t=0.3, device=dev)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
        tag = f"{name:12s} {w}x{h}"
        if counts != expected:
            raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}, expected {expected}")
        if tuple(out.shape) != (h, w, 4) or out.device != dev:
            raise AssertionError(f"{tag}: bad output {tuple(out.shape)} on {out.device}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: non-finite output")
        print(f"stochastic path {tag}: (B1, B2, B3) launches {counts}: ok")
    total = launch_counts(*wrappers)
    print(f"stochastic path: {len(STOCHASTIC)} GPU renders, (B1, B2, B3) launches {total}")
    w, h = REDUCED
    for name in STOCHASTIC:
        inputs = stochastic_inputs(st[name], w, h, "cpu", seed=50)
        want = st[name].render(*inputs, width=w, height=h, t=0.3, device="cpu")
        got = st[name].render(*(a.to(dev) for a in inputs), width=w, height=h, t=0.3,
                              device=dev).cpu()
        n_px = int((got != want).any(-1).sum())
        tag = f"stochastic {name:12s} {w}x{h} card vs CPU"
        if name in BIT_EXACT:
            if n_px:
                raise AssertionError(f"{tag}: {n_px} pixels differ, bit for bit required")
            print(f"{tag}: bit for bit")
        else:
            err = check_close(tag, got, want)
            print(f"{tag}: max abs err {err:.3e}, {n_px} pixels differ")
    return total[2]


def phase_stochastic_meshes(mt, K, B4, WL, dev, st):
    """jitter and static_tv through render_tiled(halo="auto") and
    render_sharded, rand_walk through render_sharded, on (1,4,1) and
    (1,2,2) meshes of the card at 3840x2160: one B4 (tiled), B1 or B3
    (sharded) launch per tile, and the unsharded card render's values (a
    draw hashes the global pixel index); rand_walk's tiles identical."""
    w, h = SIZES[1]
    wrappers = (K.sample_image, B4.sample_tiled, WL.while_loop)
    for name in ("jitter", "static_tv", "rand_walk"):
        f = st[name]
        inputs = stochastic_inputs(f, w, h, dev, seed=60)
        size = dict(width=w, height=h, t=0.3)
        want = f.render(*inputs, device=dev, **size)
        for entry in ("render_tiled", "render_sharded"):
            if name == "rand_walk" and entry == "render_tiled":
                continue  # samples nothing: the tiled path is the sharded one
            for shape in ((1, 4, 1), (1, 2, 2)):
                before = launch_counts(*wrappers)
                out = getattr(f, entry)(*inputs, mesh=card_mesh(mt, dev, shape), **size)
                torch.cuda.synchronize()
                counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
                expected = ((0, 0, 4) if name == "rand_walk" else
                            (0, 4, 0) if entry == "render_tiled" else (4, 0, 0))
                tag = f"{entry} {name} {w}x{h} mesh {shape}"
                if counts != expected:
                    raise AssertionError(f"{tag}: (B1, B4, B3) launches {counts}, "
                                         f"expected {expected}")
                n_px = int((out != want).any(-1).sum())
                if name == "rand_walk" and n_px:
                    raise AssertionError(f"{tag}: {n_px} pixels differ from the unsharded "
                                         f"render, identical required")
                err = check_close(tag, out, want)
                print(f"stochastic {tag}: (B1, B4, B3) launches {counts}, max abs err "
                      f"{err:.3e} vs the unsharded card render, {n_px} pixels differ")


def phase_stochastic_timings(WL, build, tracer, dev, st, card, rate, sass):
    """Median fenced 4K renders of the stochastic path, then B3 alone on
    rand_walk's loop -> B3's rand_walk record."""
    w, h = SIZES[1]
    for name, f in st.items():
        inputs = stochastic_inputs(f, w, h, dev, seed=40)
        ms = fenced_median_ms(lambda: f.render(*inputs, width=w, height=h, t=0.3, device=dev))
        print(f"timing render {name:12s} {w}x{h}{' u8 in' if inputs else ''}: median "
              f"{ms:.3f} ms/frame of {TIMED_RENDERS}, {w * h / ms / 1e3:.1f} Mpix/s [{card}]")
    return time_b3(WL, build, tracer, lambda: st["rand_walk"].render(width=w, height=h,
                                                                      device=dev),
                   f"rand_walk {w}x{h}", card, rate, sass)


class KernelCapture:
    """Records the arguments (`calls`) and results (`results`) of every
    call of `module.name` (a kernel wrapper the renderer calls:
    runtime.sampling's sample_kernel, B1, or tiled_kernel, B4) while
    active."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []
        self.results = []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            self.calls.append((args, kwargs))
            out = orig(*args, **kwargs)
            self.results.append(out)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def fenced_median_ms(call, n: int = TIMED_RENDERS) -> float:
    """Median host ms of `n` calls, each fenced by synchronize, after two
    warm-up calls."""
    for _ in range(2):
        call()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def grid_sample_tiled(ext, x, y, gh: int, gw: int, row_base: int):
    """B4's function on an interior tile's in-contract taps (columns not
    split, the default transparent edge color) as one PyTorch call:
    bilinear grid_sample of the f32 block with coordinates localised to
    the block beforehand; zero padding is the transparent color edge across
    the frame's left and right borders, and the rows never leave the
    block. Returns (call, its (4, H, W) output)."""
    import torch.nn.functional as F

    ext_h, ext_w = ext.shape[:2]
    src = ext.permute(2, 0, 1)[None].contiguous()
    px = x + (gw * 0.5 - 0.5)
    py = (gh * 0.5 - 0.5) - y - row_base
    grid = torch.stack([(px + 0.5) * (2.0 / ext_w) - 1.0,
                        (py + 0.5) * (2.0 / ext_h) - 1.0], dim=-1)[None]

    def call():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    return call, call()[0]


def phase_tiled_timings(mt, B4, sampling, dev, filters, card):
    """Tiled pond 4K on (1,4,1) beside unsharded pond 4K; B4 alone on the
    interior tile's block and coordinates against its plain version,
    grid_sample and its bound."""
    gw, gh = SIZES[1]
    _, u8 = seeded_image(gw, gh, seed=4)
    img = torch.from_numpy(u8).to(dev)
    f = filters["pond"]
    mesh = card_mesh(mt, dev, (1, 4, 1))
    runs = [fenced_median_ms(lambda: f.render(img, device=dev)),
            fenced_median_ms(lambda: f.render_tiled(img, mesh=mesh)),
            fenced_median_ms(lambda: f.render_tiled(img, mesh=mesh)),
            fenced_median_ms(lambda: f.render(img, device=dev))]
    print(f"timing render pond {gw}x{gh} u8 in: unsharded median {runs[0]:.3f} / "
          f"{runs[3]:.3f} ms/frame, tiled (1,4,1) halo (27, 2) median {runs[1]:.3f} / "
          f"{runs[2]:.3f} ms/frame (order: unsharded, tiled, tiled, unsharded; "
          f"{TIMED_RENDERS} renders each) [{card}]")
    with KernelCapture(sampling, "tiled_kernel") as cap:
        f.render_tiled(img, mesh=mesh)
    (ext, x, y, tgh, tgw, row_base, col_base, col_sharded, interp, ex, ey, col), kw = \
        cap.calls[1]
    args = (ext, x, y, tgh, tgw, row_base, col_base, col_sharded, interp, ex, ey, col)
    kernel_ms, plain_ms = turns(lambda: B4.sample_tiled_reference(*args),
                                lambda: B4.sample_tiled(*args, **kw), 5, 50)
    unchecked_ms = event_ms(lambda: B4.sample_tiled(*args, check=False), 50)
    got, excess = B4.sample_tiled(*args, **kw)
    want, want_excess = B4.sample_tiled_reference(*args)
    err = check_close("timed B4", got, want)
    if int(excess) != int(want_excess) or int(excess) > 0:
        raise AssertionError(f"timed B4: excess {int(excess)}, plain {int(want_excess)}")
    lib, lib_out = grid_sample_tiled(ext, x, y, tgh, tgw, row_base)
    lib_ms = event_ms(lib, 50)
    n_bytes = ext.numel() * 4 + (x.numel() + y.numel()) * 4 + got.numel() * 4
    bound, by = bound_ms(n_bytes)
    print(f"timing B4 pond {gw}x{gh} interior tile of (1,4,1), block {tuple(ext.shape[:2])} "
          f"f32, {interp}, check={kw.get('check')}: kernel {kernel_ms:.4f} ms (check=False "
          f"{unchecked_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x), max abs err {err:.3e}, excess "
          f"{int(excess)}; grid_sample {lib_ms:.4f} ms (max abs diff "
          f"{float((lib_out - got).abs().max()):.2e}); bound {bound:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB) [{card}]")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


#: the param batch: 8 mandelbrot jobs at 4K, zoom 1 to 3, each centred
#: on a point of the main cardioid's boundary e^(iθ)/2 - e^(2iθ)/4
BATCH_JOBS = 8
#: BASELINE config 5 (benchmarks/run_configs.py): default mandelbrot and
#: moire at 4K, each an 8-frame t-sweep at t = (i + 0.37)/8
CONFIG5 = ("mandelbrot", "moire")
CONFIG5_TS = (np.arange(BATCH_JOBS, dtype=np.float32) + np.float32(0.37)) / BATCH_JOBS
#: twirl's angles in the shared-image batch (inside its declared -10..10)
TWIRL_ANGLES = tuple(float(a) for a in np.linspace(-8.0, 8.0, BATCH_JOBS))
#: BASELINE config 4 (benchmarks/run_configs.py): ripple at 1080p with
#: "4x AA", RenderOptions(supersample=2) (a 2x2 grid of subsamples a
#: pixel), a 120-frame t-sweep
ANIMATION_FRAMES = 120
ANIMATION_SUPERSAMPLE = 2
#: the animated input's frame count (1080p u8 on the card)
ANIMATED_FRAMES = 8
#: frame values whose index the card must select as the oracle does:
#: NumPy's float32 -> int32 cast gives INT_MIN for NaN, ±inf and |v| >= 2^31
#: (frame 0 after the clip), where CUDA's conversion saturates
FRAME_VALUES = (float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 5.4, 7.6, -0.6, 2.5)
#: frames of the mesh frame-axis sweep
SWEEP_FRAMES = 4
#: a warped per-pixel frame selection (the gather route, no kernel)
PER_PIXEL_WARP = "origValXY(x * 0.9 + 1.3, y * 0.8 - 0.7, if x >= 0 then 2 else 0 end)"


def batch_params() -> list:
    out = []
    for k in range(BATCH_JOBS):
        c = np.exp(2j * np.pi * (k + 0.5) / BATCH_JOBS)
        c = c / 2 - c * c / 4
        out.append({"zoom": 1.0 + 2.0 * k / (BATCH_JOBS - 1),
                    "cx": round(float(c.real), 4), "cy": round(float(c.imag), 4)})
    return out


def oracle_frame_index(value: float, n_frames: int) -> int:
    """The reference oracle's frame index in NumPy: floor(f + 0.5) in
    float32, cast to int32 (INT_MIN where the value has no int32), clipped
    to [0, T-1]."""
    with np.errstate(invalid="ignore"):
        fi = np.floor(np.float32(value) + np.float32(0.5)).astype(np.int32)
    return int(np.clip(fi, 0, n_frames - 1))


def equal_jobs(out, lone: list) -> int:
    """How many of the batch's jobs differ from their lone renders."""
    return sum(0 if torch.equal(out[i], one) else 1 for i, one in enumerate(lone))


def phase_batch(mt, K, L, WL, dev, filters):
    """Filter.render_batch at 3840x2160: the 8 mandelbrot jobs (a list of
    param dicts, frames 0) launch B3 and B2 once a job and reuse one build
    of the loop; twirl over one shared() u8 image at 8 angles with uint8
    output launches B1 once a job; BASELINE config 5's t-sweeps of default
    mandelbrot (B3 and B2 once a frame) and moire (no kernel). Every job
    equals its lone card render bit for bit (time_batch times them)."""
    w, h = SIZES[1]
    wrappers = (K.sample_image, L.apply_lut, WL.while_loop)
    mandel, twirl = filters["mandelbrot"], filters["twirl"]
    params = batch_params()
    frames = [0.0] * BATCH_JOBS
    builds, launchers = WL.while_loop.builds, len(WL._LAUNCHERS)
    before = launch_counts(*wrappers)
    out = mandel.render_batch(width=w, height=h, params=params, frames=frames, device=dev)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
    tag = f"batch mandelbrot {w}x{h} {BATCH_JOBS} jobs"
    if counts != (0, BATCH_JOBS, BATCH_JOBS):
        raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}")
    if (WL.while_loop.builds, len(WL._LAUNCHERS)) != (builds, launchers):
        raise AssertionError(f"{tag}: the batch built its loop again")
    if tuple(out.shape) != (BATCH_JOBS, h, w, 4) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    lone = [mandel.render(width=w, height=h, params=p, device=dev) for p in params]
    differ = equal_jobs(out, lone)
    if differ:
        raise AssertionError(f"{tag}: {differ} jobs differ from their lone renders")
    print(f"{tag} (zoom 1..3 on the cardioid's boundary): (B1, B2, B3) launches {counts}, "
          f"while_loop.builds {builds} before and after; every job equals its lone render "
          f"bit for bit")
    _, u8 = seeded_image(w, h, seed=16)
    img = torch.from_numpy(u8).to(dev)
    u8_out = mt.RenderOptions(output_dtype="uint8")
    tparams = [{"angle": a} for a in TWIRL_ANGLES]
    before = launch_counts(*wrappers)
    tout = twirl.render_batch(mt.shared(img), params=tparams, frames=frames, options=u8_out,
                              device=dev)
    torch.cuda.synchronize()
    tcounts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
    ttag = f"batch twirl {w}x{h} shared u8 image, {BATCH_JOBS} angles, uint8 out"
    if tcounts != (BATCH_JOBS, 0, 0):
        raise AssertionError(f"{ttag}: (B1, B2, B3) launches {tcounts}")
    if tuple(tout.shape) != (BATCH_JOBS, h, w, 4) or tout.dtype != torch.uint8:
        raise AssertionError(f"{ttag}: bad output {tuple(tout.shape)} {tout.dtype}")
    tlone = [twirl.render(img, params=p, options=u8_out, device=dev) for p in tparams]
    differ = equal_jobs(tout, tlone)
    if differ:
        raise AssertionError(f"{ttag}: {differ} jobs differ from their lone renders")
    print(f"{ttag}: (B1, B2, B3) launches {tcounts}; every job equals its lone render bit "
          f"for bit")
    for name in CONFIG5:
        f = filters[name]
        before = launch_counts(*wrappers)
        out = f.render_batch(width=w, height=h, ts=CONFIG5_TS, device=dev)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
        tag = f"config 5 {name} {w}x{h}, {BATCH_JOBS}-frame t-sweep"
        want = (0, BATCH_JOBS, BATCH_JOBS) if name == "mandelbrot" else (0, 0, 0)
        if counts != want:
            raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}, expected {want}")
        if tuple(out.shape) != (BATCH_JOBS, h, w, 4) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
        lone = [f.render(width=w, height=h, t=float(t), frame=float(i), device=dev)
                for i, t in enumerate(CONFIG5_TS)]
        differ = equal_jobs(out, lone)
        if differ:
            raise AssertionError(f"{tag}: {differ} frames differ from their lone renders")
        print(f"{tag} (render_batch, ts = (i + 0.37)/{BATCH_JOBS}): (B1, B2, B3) launches "
              f"{counts}; every frame equals render(t=ts[i], frame=i) bit for bit")


def time_batch(mt, dev, filters, card):
    """Median fenced render_batch calls of phase_batch's batches beside the
    lone render of their first job: ms a job, in turns."""
    w, h = SIZES[1]
    mandel, twirl = filters["mandelbrot"], filters["twirl"]
    params = batch_params()
    frames = [0.0] * BATCH_JOBS
    img = torch.from_numpy(seeded_image(w, h, seed=16)[1]).to(dev)
    u8_out = mt.RenderOptions(output_dtype="uint8")
    tparams = [{"angle": a} for a in TWIRL_ANGLES]
    for name, batch, one in (
            ("mandelbrot", lambda: mandel.render_batch(width=w, height=h, params=params,
                                                       frames=frames, device=dev),
             lambda: mandel.render(width=w, height=h, params=params[0], device=dev)),
            ("twirl", lambda: twirl.render_batch(mt.shared(img), params=tparams, frames=frames,
                                                 options=u8_out, device=dev),
             lambda: twirl.render(img, params=tparams[0], options=u8_out, device=dev)),
            *((f"config 5 {n} t-sweep",
               lambda f=filters[n]: f.render_batch(width=w, height=h, ts=CONFIG5_TS,
                                                   device=dev),
               lambda f=filters[n]: f.render(width=w, height=h, t=float(CONFIG5_TS[0]),
                                             device=dev))
              for n in CONFIG5)):
        runs = [fenced_median_ms(one), fenced_median_ms(batch, n=5),
                fenced_median_ms(batch, n=5), fenced_median_ms(one)]
        job = (runs[1] + runs[2]) / 2 / BATCH_JOBS
        print(f"timing batch {name} {w}x{h}: {job:.3f} ms a job ({BATCH_JOBS} jobs a call, "
              f"median of 5 calls: {runs[1]:.3f} / {runs[2]:.3f} ms), lone render median "
              f"{runs[0]:.3f} / {runs[3]:.3f} ms (order: lone, batch, batch, lone) [{card}]")


def phase_animation(mt, K, dev, filters):
    """BASELINE config 4: ripple at 1920x1080 with supersample=2 through
    Filter.render_animation(num_frames=120) on a smooth seeded u8 image on
    the card: one B1 launch a subsample of every frame; frames 0, 37 and
    119 equal render(t=..., frame=...) bit for bit, frame 37 matches the
    port's CPU render (rtol=1e-4, atol=1e-5), render_frames yields the same
    frames (time_animation times the sweep)."""
    w, h = SIZES[0]
    _, u8 = smooth_image(w, h, seed=15)
    img = torch.from_numpy(u8).to(dev)
    f = filters["ripple"]
    opts = mt.RenderOptions(supersample=ANIMATION_SUPERSAMPLE)
    n = ANIMATION_FRAMES
    before = K.sample_image.launches
    out = f.render_animation(img, num_frames=n, options=opts, device=dev)
    torch.cuda.synchronize()
    launches = K.sample_image.launches - before
    tag = f"animation ripple {w}x{h} supersample={ANIMATION_SUPERSAMPLE}, {n} frames"
    per_frame = ANIMATION_SUPERSAMPLE ** 2
    if launches != n * per_frame:
        raise AssertionError(f"{tag}: {launches} B1 launches, expected {n} x {per_frame}")
    if tuple(out.shape) != (n, h, w, 4) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    ts = np.arange(n, dtype=np.float32) / n
    for i in (0, 37, n - 1):
        lone = f.render(img, t=float(ts[i]), frame=float(i), options=opts, device=dev)
        if not torch.equal(out[i], lone):
            raise AssertionError(f"{tag}: frame {i} differs from render(t={ts[i]}, frame={i})")
    ref = f.render(u8, t=float(ts[37]), frame=37.0, options=opts, device="cpu")
    err = check_close(f"{tag} frame 37 vs the CPU", out[37].cpu(), ref)
    n_px = int(((out[37].cpu() - ref).abs() > 0).any(-1).sum())
    differ = sum(0 if torch.equal(fr, out[i]) else 1
                 for i, fr in enumerate(f.render_frames(img, num_frames=n, options=opts,
                                                        device=dev)))
    if differ:
        raise AssertionError(f"{tag}: render_frames differs from render_animation at "
                             f"{differ} frames")
    print(f"{tag}: {launches} B1 launches ({per_frame} subsamples x {n} frames, one each); "
          f"frames 0, 37, {n - 1} equal their lone renders bit for bit; frame 37 vs the CPU "
          f"render max abs err {err:.3e}, {n_px} pixels differ; render_frames yields the "
          f"same {n} frames")


def time_animation(mt, dev, filters, card):
    """phase_animation's sweep timed: two fenced render_animation calls of
    ANIMATION_FRAMES frames, ms a frame, beside the lone render's median."""
    w, h = SIZES[0]
    img = torch.from_numpy(smooth_image(w, h, seed=15)[1]).to(dev)
    f = filters["ripple"]
    opts = mt.RenderOptions(supersample=ANIMATION_SUPERSAMPLE)
    n = ANIMATION_FRAMES
    anim = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f.render_animation(img, num_frames=n, options=opts, device=dev)
        torch.cuda.synchronize()
        anim.append((time.perf_counter() - t0) * 1e3 / n)
    lone_ms = fenced_median_ms(lambda: f.render(img, t=0.3, frame=1.0, options=opts,
                                                device=dev))
    print(f"timing animation ripple {w}x{h} supersample={ANIMATION_SUPERSAMPLE}: "
          f"{anim[0]:.3f} / {anim[1]:.3f} ms a frame (two {n}-frame calls), "
          f"{w * h / min(anim) / 1e3:.1f} Mpix/s; lone render median {lone_ms:.3f} ms [{card}]")


def phase_animated_inputs(mt, K, sampling, dev):
    """An 8-frame 1920x1080 u8 stack on the card: origVal(xy) with nearest
    sampling through render_animation returns each frame exactly (one B1
    launch a frame); origValXY(x, y, 3) selects frame 3 through B1 (a view
    of the stack, no copy; B1's result held against its plain version); a
    warped per-pixel frame plane goes through the gather route (no B1) and
    equals B1 on each frame it selects and the CPU render; the frame values of FRAME_VALUES select the oracle's frame
    on the Python-float, 0-d tensor and per-pixel routes."""
    w, h = SIZES[0]
    T = ANIMATED_FRAMES
    stack_np = np.stack([seeded_image(w, h, seed=70 + k)[1] for k in range(T)])
    stack = torch.from_numpy(stack_np).to(dev)
    want = K.u8_to_float(stack)
    near = mt.RenderOptions(interpolation="nearest")
    ident = mt.compile_source("origVal(xy)")
    before = K.sample_image.launches
    out = ident.render_animation(stack, num_frames=T, options=near, device=dev)
    torch.cuda.synchronize()
    if K.sample_image.launches - before != T or not torch.equal(out, want):
        raise AssertionError("animated input: origVal(xy) does not return each frame")
    print(f"animated input {T}x{w}x{h} u8: origVal(xy) nearest through render_animation "
          f"returns each frame exactly, {T} B1 launches")
    with KernelCapture(sampling, "sample_kernel") as cap:
        out = mt.compile_source("origValXY(x, y, 3)").render(stack, options=near, device=dev)
    torch.cuda.synchronize()
    (pix, *rest), _ = cap.calls[0]
    if len(cap.calls) != 1 or pix.data_ptr() != stack[3].data_ptr():
        raise AssertionError("origValXY(x, y, 3): B1 did not sample frame 3's view")
    err = check_close("B1 on frame 3 of an animated stack", cap.results[0],
                      K.sample_image_reference(pix, *rest))
    if not torch.equal(out, want[3]):
        raise AssertionError("origValXY(x, y, 3) does not return frame 3")
    print(f"animated input: origValXY(x, y, 3) through B1 on frame 3's view of the stack "
          f"(no copy): frame 3 exactly; B1 vs plain max abs err {err:.3e}")
    worst = err
    plane = mt.compile_source(PER_PIXEL_WARP)
    before = K.sample_image.launches
    out = plane.render(stack, device=dev)
    torch.cuda.synchronize()
    if K.sample_image.launches != before:
        raise AssertionError("per-pixel frame plane: the gather route launched B1")
    # the independent version: B1 on each selected frame at the warp's
    # coordinates, chosen per pixel by the plane's selector
    xs = torch.arange(w, dtype=torch.float32, device=dev) + (0.5 - w / 2)
    ys = (h / 2 - 0.5) - torch.arange(h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    wx = (gx * 0.9 + 1.3).contiguous()
    wy = (gy * 0.8 - 0.7).contiguous()
    opts = mt.RenderOptions()
    counted = K.sample_image.launches
    by_frame = {k: K.sample_image(stack[k], wx, wy, opts.interpolation, opts.edge_x,
                                  opts.edge_y, opts.edge_color).permute(1, 2, 0)
                for k in (0, 2)}
    K.sample_image.launches = counted  # comparison launches are not the path's
    want_plane = torch.where((gx >= 0)[..., None], by_frame[2], by_frame[0]).clamp(0, 1)
    err = check_close("per-pixel frame plane vs B1 on each frame", out, want_plane)
    ref = plane.render(stack_np, device="cpu")
    cpu_err = check_close("per-pixel frame plane vs the CPU", out.cpu(), ref)
    print(f"animated input: a warped bilinear per-pixel frame plane goes through the gather "
          f"route (0 B1 launches); vs B1 on frames 0 and 2 chosen per pixel max abs err "
          f"{err:.3e}, vs the CPU render {cpu_err:.3e}")
    routes = {"frame=": lambda v: ident.render(stack, frame=v, options=near, device=dev),
              "origValXY(x, y, t)": lambda v: mt.compile_source("origValXY(x, y, t)").render(
                  stack, t=v, options=near, device=dev),
              "origValXY(x, y, t + x * 0)": lambda v: mt.compile_source(
                  "origValXY(x, y, t + x * 0)").render(stack, t=v, options=near, device=dev)}
    expected = [oracle_frame_index(v, T) for v in FRAME_VALUES]
    for route, render in routes.items():
        got = []
        for v in FRAME_VALUES:
            o = render(v)
            got.append(next((k for k in range(T) if torch.equal(o, want[k])), None))
        if got != expected:
            raise AssertionError(f"frame values {FRAME_VALUES} through {route} select {got}, "
                                 f"the oracle {expected}")
        print(f"animated input: frame values {list(FRAME_VALUES)} through {route} select "
              f"frames {got}, as the oracle does")
    return worst


def phase_frame_axis(mt, K, B4, sampling, dev, filters):
    """The mesh's frame axis: ripple over a 4-frame 1080p u8 stack through
    render_sharded(num_frames=4) on (4,1,1) and (2,2,1) meshes of the card
    against the four lone card renders (frame i at t = i/4, sampling input
    frame i); the same stack through render_tiled on (1,4,1) at each frame
    against the unsharded render, one B4 launch a tile and frame, and B4's
    result on an animated block against its plain version."""
    w, h = SIZES[0]
    n = SWEEP_FRAMES
    stack = torch.from_numpy(np.stack([smooth_image(w, h, seed=90 + k)[1]
                                       for k in range(n)])).to(dev)
    f = filters["ripple"]
    ts = np.arange(n, dtype=np.float32) / n
    lone = [f.render(stack, t=float(ts[i]), frame=float(i), device=dev) for i in range(n)]
    for shape in ((4, 1, 1), (2, 2, 1)):
        tiles = shape[1] * shape[2]
        before = K.sample_image.launches
        out = f.render_sharded(stack, mesh=card_mesh(mt, dev, shape), num_frames=n)
        torch.cuda.synchronize()
        launches = K.sample_image.launches - before
        tag = f"frame axis: render_sharded ripple {n}x{w}x{h} u8 stack, mesh {shape}"
        if launches != n * tiles or tuple(out.shape) != (n, h, w, 4):
            raise AssertionError(f"{tag}: {launches} B1 launches, shape {tuple(out.shape)}")
        errs, n_px = [], 0
        for i in range(n):
            errs.append(check_close(f"{tag} frame {i}", out[i], lone[i]))
            n_px += int((out[i] != lone[i]).any(-1).sum())
        print(f"{tag}: {launches} B1 launches ({tiles} a frame), max abs err {max(errs):.3e} "
              f"vs the lone card renders, {n_px} pixels differ")
    mesh = card_mesh(mt, dev, (1, 4, 1))
    before = B4.sample_tiled.launches
    errs, n_px = [], 0
    with KernelCapture(sampling, "tiled_kernel") as cap:
        for i in range(n):
            out = f.render_tiled(stack, mesh=mesh, t=0.3, frame=float(i))
            want = f.render(stack, t=0.3, frame=float(i), device=dev)
            errs.append(check_close(f"render_tiled animated frame {i}", out, want))
            n_px += int((out != want).any(-1).sum())
    torch.cuda.synchronize()
    launches = B4.sample_tiled.launches - before
    if launches != 4 * n:
        raise AssertionError(f"animated render_tiled: {launches} B4 launches for 4 tiles x "
                             f"{n} frames")
    (ext, *rest), kw = cap.calls[5]
    got, excess = cap.results[5]
    want, want_excess = B4.sample_tiled_reference(ext, *rest)
    err = check_close("B4 on an animated block", got, want)
    if int(excess) != int(want_excess):
        raise AssertionError(f"B4 on an animated block: excess {int(excess)} != "
                             f"{int(want_excess)}")
    print(f"frame axis: render_tiled ripple {n}x{w}x{h} u8 stack, mesh (1,4,1), frames "
          f"0..{n - 1}: {launches} B4 launches (one a tile and frame), max abs err "
          f"{max(errs):.3e} vs the unsharded card render, {n_px} pixels differ; B4 on frame "
          f"1's block {tuple(ext.shape[:2])} vs plain max abs err {err:.3e}, equal excess")
    return err


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
    from mathmap_tpu_torch.kernels import apply_lut as L
    from mathmap_tpu_torch.kernels import build
    from mathmap_tpu_torch.kernels import sample_image as K
    from mathmap_tpu_torch.kernels import sample_tiled as B4
    from mathmap_tpu_torch.kernels import while_loop as WL
    from mathmap_tpu_torch.runtime import sampling, tracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    filters = {n: mt.compile_file(str(ROOT / "filters" / "Distorts" / f"{n}.mm"))
               for n in FILTERS + ("ripple",)}
    filters.update({n: mt.compile_file(str(ROOT / "filters" / "Render" / f"{n}.mm"))
                    for n in GENERATIVE + CONFIG5[1:]})
    sin_filter = mt.compile_source(SIN_BODY)
    rand_walk = mt.compile_source(RAND_WALK)
    st = {n: rand_walk if folder is None
          else mt.compile_file(str(ROOT / "filters" / folder / f"{n}.mm"))
          for n, (folder, _) in STOCHASTIC.items()}
    loop_filters = [(filters[n], {}) for n in GENERATIVE]
    loop_filters += [(filters["mandelbrot"], ZOOMED), (sin_filter, {}), (rand_walk, {})]
    card = phase_card(mt, build, WL, tracer, loop_filters)
    rate, sms, mhz = single_op_rate()
    print(f"single-op issue rate: {sms} SMs x {LANES_PER_SM} lanes x {mhz:.0f} MHz "
          f"(clocks.max.sm) = {rate / 1e12:.2f}e12 op/s; INT32 half that")
    worst_b1 = phase_kernel_vs_plain(K, dev)
    worst_b2 = phase_lut_vs_plain(L, dev)
    worst_b3, worst_rand = phase_loop_vs_plain(mt, WL, tracer, dev, filters, sin_filter,
                                               rand_walk)
    worst_b4 = phase_tiled_vs_plain(B4, dev)
    # each main path with every launch count set to 0 just before it and
    # read just after (B1, B2, B3, B4)
    wrappers = (K.sample_image, L.apply_lut, WL.while_loop, B4.sample_tiled)
    by_path = {}

    def path(name, phase, *args):
        for wrapper in wrappers:
            wrapper.launches = 0
        result = phase(*args)
        torch.cuda.synchronize()
        by_path[name] = launch_counts(*wrappers)
        return result

    path("distortion", phase_distortion_path, mt, K, dev, filters)
    path("generative", phase_generative_path, mt, L, WL, dev, filters)
    path("tiled", phase_tiled_path, mt, B4, dev, filters)
    path("sharded", phase_sharded_path, mt, K, L, WL, dev, filters)
    phase_rand_noise_vs_cpu(dev)
    b3_rand_launches = path("stochastic", phase_stochastic_path, mt, K, L, WL, dev, st)
    path("stochastic meshes", phase_stochastic_meshes, mt, K, B4, WL, dev, st)
    path("batch", phase_batch, mt, K, L, WL, dev, filters)
    path("animation", phase_animation, mt, K, dev, filters)
    worst_b1 = max(worst_b1, path("animated inputs", phase_animated_inputs, mt, K, sampling,
                                  dev))
    worst_b4 = max(worst_b4, path("frame axis", phase_frame_axis, mt, K, B4, sampling, dev,
                                  filters))
    names = ("sample_image", "apply_lut", "while_loop", "sample_tiled")
    launches = {name: {p: c[k] for p, c in by_path.items() if c[k]}
                for k, name in enumerate(names)}
    for name, paths in launches.items():
        if not paths:
            raise AssertionError(f"{name}: launched on no main path")
        print(f"launches {name}: {sum(paths.values())} on the main paths, {paths}")
    sass = {}
    b1 = phase_timings(mt, K, sampling, dev, filters, card)
    gen = phase_generative_timings(mt, L, WL, build, tracer, dev, filters, card, rate, sass)
    b4 = phase_tiled_timings(mt, B4, sampling, dev, filters, card)
    b3_rand = phase_stochastic_timings(WL, build, tracer, dev, st, card, rate, sass)
    time_batch(mt, dev, filters, card)
    time_animation(mt, dev, filters, card)
    print(f"nvcc builds in this run: {len(build.BUILDS)}, "
          f"{sum(s for _, s in build.BUILDS):.2f} s in all")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(card)

    def counted(name):
        return dict(launches=sum(launches[name].values()), launches_by_path=launches[name])

    print(json.dumps({"kernels": [
        {"name": "sample_image", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/sample_image.cu",
         "replaces": "mathmap_tpu/pallas_kernels/sample_kernel.py:741",
         **counted("sample_image"), "max_abs_err": worst_b1, **b1},
        {"name": "apply_lut", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/apply_lut.cu",
         "replaces": "mathmap_tpu/pallas_kernels/sample_kernel.py:1279",
         **counted("apply_lut"), "max_abs_err": worst_b2, **gen["lut"]},
        {"name": "while_loop", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/while_loop.cu.tmpl",
         "replaces": "mathmap_tpu/pallas_kernels/while_kernel.py:143",
         **counted("while_loop"), "max_abs_err": worst_b3, **gen["default"]},
        {"name": "while_loop (rand_walk)", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/while_loop.cu.tmpl",
         "replaces": "mathmap_tpu/pallas_kernels/while_kernel.py:143",
         "launches": b3_rand_launches, "max_abs_err": worst_rand, **b3_rand},
        {"name": "sample_tiled", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/sample_tiled.cu",
         "replaces": "mathmap_tpu/runtime/sampling.py:188",
         **counted("sample_tiled"), "max_abs_err": worst_b4, **b4},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
