#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mathmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases, each printing its own lines:

1. card and build: the GPU's name and power limit (nvidia-smi), CUDA and
   torch versions; every kernel built by nvcc at once, one process per
   source, all started together: the library of mathmap_tpu_torch/csrc/*.cu
   (B1, B2, B4, B5, B6) and one generated while-loop kernel (B3) per distinct loop body
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
   bound, grid_sample of the same mode as yardstick (for bicubic a
   yardstick of the same taps only: PyTorch's uses A = -0.75, B1's
   Catmull-Rom A = -0.5); then B1 on the coordinate fields that fisheye,
   twirl and pond hand it at 4K (u8 source, each interpolation), the main
   path's own traffic;
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
   version;
16. library path: the six entries that needed the vector, matrix,
   quaternion and special builtins or gaussian_blur (affine, rotate,
   sharpen, gamma_spiral, elliptic_rings, quat_julia) and the 22
   compositions of filters/Compositions, each compiled by the port's
   default_db(): at 480x270 on smooth u8 images against the port's CPU
   render (rtol=1e-4, atol=1e-5; a composition may have under 2% of its
   pixels beyond, tests/test_library.py's gallery bound for pixels on a
   discontinuity), with the (B1, B2, B3) launches equal to
   the CPU render's wrapper calls; then at 3840x2160 with the same
   launches; quat_julia's vector loop through B3 (the kernel route, no
   build after phase 1), its carried grids and iteration counts identical
   to the eager loop's on the card.
17. region path (RenderOptions.region, an unaligned 28% selection of
   3840x2160): fisheye and twirl (u8 in, float32 and uint8 out; one B1
   launch), mandelbrot (B3, B2), static_tv (rand()) and rand_walk (rand()
   in B3), each equal to the card's full render cropped bit for bit; pond
   through render_tiled on a (1,4,1) mesh of cuda:0, one B4 launch a tile
   that meets the selection, the unsharded region render inside (uint8
   within 1 LSB) and input 0 outside bit for bit;
18. corners path (supersample=2, supersample_scheme='corners'): ripple at
   1920x1080, two B1 launches a frame (the (h+1, w+1) corner grid, then
   the centres); at 480x270 against the CPU port, and a region of it equal
   to the crop bit for bit;
19. CLI path: cli.main in-process over a 1920x1080 PNG (one frame,
   --frames 3, --input-dir, --param-sweep, --tiled --region), every PNG
   equal to the API's render packed to uint8 on the card, bit for bit; one
   `python -m mathmap_tpu_torch` subprocess and its wall time;
20. serve path: RenderService on the card behind the HTTP server on
   127.0.0.1, 16 concurrent /render requests of twirl 1920x1080 at 16
   angles over one u8 PNG, every reply equal to its lone render bit for
   bit; batch histogram, p50/p99 latency and requests/s;
21. selftest path: run_selftest() on cuda:0 (its ten path classes against
   the CPU route) returns 0;
22. artifact path (generators/artifact.py) at 3840x2160: twirl (B1), the
   curve filter of tests/test_generators.py (B2), default mandelbrot
   (B3, B2) and a loop reading `t` (B3, its scalars in device memory)
   exported on cuda:0 and loaded; render launches each kernel
   once through its custom op (mathmap::sample_image, apply_lut,
   while_loop) and equals the live card render bit for bit, render_batch
   (4 jobs) and render_animation (4 frames) equal the live ones; a CLI
   .mmxa frame and one artifact request through the service; export and
   load seconds (mandelbrot's load with its B3 library rebuilt by nvcc and
   without) and the artifact render beside the live one;
23. preview path: the preview app on 127.0.0.1 with cuda:0, /render
   (twirl), /animate, /compose and a region /render over a 1920x1080 u8
   image, each reply equal to its lone card render bit for bit and each
   launching B1; a /render round trip;
24. distributed path (parallel/distributed.py): a 2-process fleet over
   gloo (NCCL refuses two ranks on one card), both ranks rendering on
   cuda:0: twirl 1920x1080 through render_sharded over the global (4,1)
   mesh (B1); pond 3840x2160, u8 in, through render_tiled over the global
   (1,4,1) mesh, two tiles a rank, halo rows crossing ranks, B4 launched
   once per sampler call of each rank's tiles and summed over the ranks
   to the one-process count; a halo too small raising the same error on
   both ranks; a render_sharded LocalFrame chained into render_tiled;
   default mandelbrot 3840x2160 as a 4-frame sweep over the global
   (2,2,1) mesh, B2 and B3 on each rank; every rank's tiles equal to the
   one-process card render's over a mesh of the same shape bit for bit
   (sha256 of each tile); then 5 fenced tiled frames a rank, with the
   exchange's host time and bytes, beside the one-process tiled render.
   Then the NCCL route at world size 1 (an all_reduce of a CUDA tensor)
   and, on a machine with two cards, the tiled pond on NCCL, one card a
   rank (else a line says why it did not run). The workers are this
   script (`--distributed-worker`); their launches before the timing are
   the path's.
25. float64 spec: the reference's eight top-level names resolve on the
   port; Filter.render(interpret=True) is a CPU tensor, and interpret=True
   with device="cuda", and on_error="interpret", raise ValueError. Then
   the card's float32 render (Filter.render without a device; tiled pond
   through render_tiled on a (1,4,1) mesh of cuda:0) and the CPU's
   float32 route (interpret=True) are each held against the reference's
   float64 spec (interpret=True, precision="f64"), their worst errors
   printed side by side: fisheye, twirl, pond, twirl bicubic, mandelbrot,
   a curve filter and tiled pond at 1920x1080 on a smooth u8 image;
   quat_julia, voronoi and turbulence at 480x270. The card must stay
   within 2e-4 of the spec (tests/test_fuzz.py's bound for float32
   against float64; the escape-time mandelbrot and quat_julia: at most 2%
   of pixels beyond tests/test_parity.py's 5e-5 + 1e-4 |spec|), every
   output finite, each card render launching its kernels (B1, B2, B3,
   B4); for voronoi, which of the card and the CPU is nearer the spec
   where the two differ.
26. exported loops (the loops kernel B3 refuses, which an artifact holds
   as torch's while loop) at 3840x2160 on cuda:0: ridged_noise with
   `octaves` and `scale` as runtime inputs, rendered at octaves 1, 4 and 6
   and at two scales; a feedback loop over the input image (a runtime int
   trip count, origVal at a scaled xy every step: B1 inside the loop,
   launched once a step, the steps rounded up to whole while_unroll
   groups); rand() in a loop with atan (which B3 refuses) nested in a loop
   with a param-driven trip count, so the inner draws take the outer
   iteration as a tensor salt. Each exported and loaded; every render,
   render_batch (4 jobs) and render_animation (4 frames) equal to the live
   card render bit for bit with the same (B1, B2, B3) launches. Fault C4:
   the Perlin table's cache is emptied before the exports, so the first
   table is asked for under torch.export; after them a live 1920x1080
   turbulence render is a real CUDA tensor equal to the one taken before,
   and ridged_noise exports a second time. Timings: export and load
   seconds, the artifact's and the live render's fenced medians and
   cudaStreamSynchronize calls a render.
27. B5 vs plain (run before phase 5): the frame's finish kernel against
   its plain version (the eager chain it replaced) on the same CUDA
   tensors, bit for bit, planes seeded with NaN, ±inf and -0.0, weights
   1 and 1/9, float32 and uint8 out: at 3840x2160 and 1920x1080, into a
   batch's slice, on moire's layout (a contiguous plane, a row and a
   column broadcast and a constant), at the ragged 1919x1081 (the row's
   end masked) and into an output one element off alignment (the narrow
   instantiation, a store a channel); each case prints its
   instantiation. Timed last: B5 at 4K and 1080p, float32 and uint8 out,
   on contiguous planes and on moire's layout, in turns with the eager
   chain (its plain ms), beside its bytes bound.
28. B6 vs plain (run before phase 5): the Perlin-noise kernel against its
   plain version (the eager chain it replaced) on the same CUDA tensors,
   bit for bit (NaN, ±inf and -0.0 as bits), one launch a call: the noise
   cell's two 4K layouts (turbulence's octave planes and voronoi's cell
   coordinates, each with a 0-d z), a row and a column grid, a (job, H, W)
   batch, the ragged 1919x1081 (one store a point) and random, lattice,
   large, NaN and infinite points; B6's ptxas registers and spills. Timed
   last: B6 on the two 4K layouts in turns with the eager chain (its plain
   ms), beside its bound: the distinct input elements and the output at 4
   bytes each, and B6_OPS_PER_POINT single operations a point over the
   single-op issue rate.

Every main path (phases 5, 6, 8, 9, 11-26) runs with the six launch
counts (B1-B6) set to 0 just before it and read just after; the kernels
line gives each kernel's launches by path. Then the timings: phase 10's and
11's, B3's bound (this run's pixel iterations x the distinct ops of an
iteration, integer ops at half rate, over the single-op issue rate SMs x
128 lanes x clocks.max.sm, with the loop's SASS instruction count beside
it), the batches' ms a job and the animation's ms a frame beside their
lone renders, the library slice's 4K render medians, B3 alone on
quat_julia's loop, and gaussian_blur's 4K route beside F.conv2d computing
the same blur with TF32 off; region against full (twirl and mandelbrot at
4K), a corners frame against a plain and a grid supersample=2 frame
(ripple 1080p), and a CLI frame split into PNG decode, render and PNG
encode.

Kernel times are CUDA events around a run of launches that the card starts
only after a sleep kernel, so the host has enqueued the run by then and the
events time the device, not the host's launch rate.

The line before the last is the JSON record of the kernels; the last line
is {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA GPU, or without the package beside this file, the script
exits non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
        sources.setdefault(WL.emit_cuda(tracer.trace(loop, len(flat0)), loop.origin), loop)
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
    zero_launches(LAUNCH_B1)
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
                before = launch_count(LAUNCH_B1)
                out = f.render(img, params=params, options=opts, device=dev)
                torch.cuda.synchronize()
                renders += 1
                if launch_count(LAUNCH_B1) != before + 1:
                    raise AssertionError(
                        f"{name} {w}x{h}: {launch_count(LAUNCH_B1) - before} "
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
    launches = launch_count(LAUNCH_B1)
    if launches != renders:
        raise AssertionError(f"{launches} sampler launches for {renders} renders")
    print(f"distortion path: {renders} GPU renders, {launches} sampler kernel launches")
    return launches


def grid_sample_image(pix, x, y, mode: str = "bilinear"):
    """B1's function as one PyTorch call: grid_sample (`mode` "bilinear",
    "nearest", or "bicubic", whose weights differ from B1's) with zero
    padding (the transparent edge color) on the float32 NCHW copy of
    `pix`; returns (call, its (4, H, W) output). The layout copy and the
    normalised grid are made here, outside the timed call."""
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


#: the grid_sample mode beside each of B1's interpolations, its yardstick
GRID_SAMPLE_MODE = {"nearest": "nearest", "bilinear": "bilinear", "bicubic": "bicubic"}
#: grid_sample's bicubic reads B1's 16 taps with other weights
BICUBIC_YARDSTICK = ("; PyTorch's bicubic is the cubic convolution with A = -0.75, "
                     "B1's Catmull-Rom has A = -0.5: the same taps and work, another "
                     "function")


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
    mode = GRID_SAMPLE_MODE[interp]
    lib, lib_out = grid_sample_image(pix, x, y, mode)
    lib_ms = lib_bilinear if mode == "bilinear" else event_ms(lib, 50)
    line += (f"grid_sample {mode} {lib_ms:.4f} ms (max abs diff "
             f"{float((lib_out - got).abs().max()):.2e})")
    if mode == "bicubic":
        line += BICUBIC_YARDSTICK
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
                  grid_sample_bicubic_ms=records[(w, h, "u8", "bicubic")]["library_ms"],
                  grid_sample_nearest_ms=records[(w, h, "u8", "nearest")]["library_ms"],
                  instantiation=f"sample_image_kernel<uchar4, bilinear, V={vec}>")
    return record


def phase_generative_path(mt, L, WL, dev, filters):
    """Every render launches the loop kernel once and the LUT kernel once;
    1080p matches the CPU port."""
    from mathmap_tpu_torch.kernels.finish_rgba import pack_uint8

    zero_launches(LAUNCH_B2)
    zero_launches(LAUNCH_B3)
    renders = 0
    cpu = {}
    for (w, h) in SIZES:
        cases = [(n, p, o) for n, p in (("mandelbrot", {}), ("mandelbrot", ZOOMED))
                 for o in ("float32", "uint8")]
        if (w, h) == SIZES[1]:
            cases += [("julia", {}, "float32"), ("burning_ship", {}, "float32")]
        for name, params, out_dtype in cases:
            opts = mt.RenderOptions(output_dtype=out_dtype)
            before = (launch_count(LAUNCH_B2), launch_count(LAUNCH_B3))
            out = filters[name].render(width=w, height=h, params=params,
                                       options=opts, device=dev)
            torch.cuda.synchronize()
            renders += 1
            counts = (launch_count(LAUNCH_B2) - before[0], launch_count(LAUNCH_B3) - before[1])
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
    counts = (launch_count(LAUNCH_B2), launch_count(LAUNCH_B3))
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
    prog = tracer.trace(loop, len(flat0))
    want, steps, iters = loop_reference(WL, loop, flat0, mask0, max_iters)
    kernel_ms, plain_ms = turns(
        lambda: WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                        loop.it_base),
        lambda: tracer.loop_kernel(loop, flat0, mask0, max_iters), 2, 20)
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
    same = all(torch.equal(a, b)
               for a, b in zip(tracer.loop_kernel(loop, flat0, mask0, max_iters), want))
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
    zero_launches(LAUNCH_B4)
    renders = 0
    gw, gh = SIZES[1]
    _, u8 = seeded_image(gw, gh, seed=12)
    img = torch.from_numpy(u8).to(dev)
    for name, params in TILED_FILTERS:
        f = filters[name]
        want = f.render(img, params=params, t=0.3, device=dev)
        for shape in TILED_MESHES:
            mesh = card_mesh(mt, dev, shape)
            before = launch_count(LAUNCH_B4)
            out = f.render_tiled(img, mesh=mesh, params=params, t=0.3)
            torch.cuda.synchronize()
            renders += 1
            tiles = mesh.devices.size
            tag = (f"tiled {name:6s} {'default' if not params else 'amplitude=25'} "
                   f"{gw}x{gh} u8 in, mesh {tuple(mesh.devices.shape)}")
            if launch_count(LAUNCH_B4) - before != tiles:
                raise AssertionError(f"{tag}: {launch_count(LAUNCH_B4) - before} B4 "
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
    launches = launch_count(LAUNCH_B4)
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
        before = (launch_count(LAUNCH_B1), launch_count(LAUNCH_B2), launch_count(LAUNCH_B3))
        out = f.render_sharded(*inputs, mesh=card_mesh(mt, dev, shape), **size)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(
            (launch_count(LAUNCH_B1), launch_count(LAUNCH_B2), launch_count(LAUNCH_B3)), before))
        expected = (4, 0, 0) if name == "pond" else (0, 4, 4)
        tag = f"sharded {name} {gw}x{gh} mesh {shape}"
        if counts != expected:
            raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}, expected {expected}")
        err = check_close(tag, out, want)
        n_px = int(((out - want).abs() > 0).any(-1).sum())
        print(f"sharded path {tag}: (B1, B2, B3) launches {counts}, max abs err {err:.3e} "
              f"vs the unsharded card render, {n_px} pixels differ")


#: the program's launch counters (utils/trace.py) of kernels B1-B6
LAUNCH_B1, LAUNCH_B2, LAUNCH_B3, LAUNCH_B4, LAUNCH_B5, LAUNCH_B6 = (
    "launch.sample_image", "launch.apply_lut", "launch.while_loop", "launch.sample_tiled",
    "launch.finish_rgba", "launch.perlin3")
#: each counter's value when zero_launches last named it
_LAUNCH_ZERO: dict = {}


def launch_count(name: str) -> int:
    """A kernel's launches since zero_launches last named its counter."""
    from mathmap_tpu_torch.utils.trace import counter

    return counter(name) - _LAUNCH_ZERO.get(name, 0)


def zero_launches(*names) -> None:
    """Count each named kernel's launches from 0 from here."""
    from mathmap_tpu_torch.utils.trace import counter

    for name in names:
        _LAUNCH_ZERO[name] = counter(name)


def set_launches(name: str, value: int) -> None:
    """Make launch_count(name) read `value` from here."""
    from mathmap_tpu_torch.utils.trace import counter

    _LAUNCH_ZERO[name] = counter(name) - value


def launch_counts(*names) -> tuple:
    return tuple(launch_count(n) for n in names)


def loop_routes() -> dict:
    """The loop runs of this process by route (the program's `loop.<route>`
    counters, utils/trace.py)."""
    from mathmap_tpu_torch.utils.trace import snapshot

    return {name[len("loop."):]: n for name, n in snapshot()["counters"].items()
            if name.startswith("loop.") and not name.endswith(".steps")}


def nvcc_builds() -> int:
    """nvcc runs in this process (the program's `build.nvcc` counter)."""
    from mathmap_tpu_torch.utils.trace import counter

    return counter("build.nvcc")


def stochastic_inputs(f, w: int, h: int, dev, seed: int) -> list:
    """Seeded u8 images on `dev`, one per image parameter of `f`."""
    n = sum(1 for p in f.fdef.params if p.kind == "image")
    return [torch.from_numpy(seeded_image(w, h, seed=seed + i)[1]).to(dev) for i in range(n)]


def phase_rand_noise_vs_cpu(dev):
    """rand()'s hash and perlin3 (kernel B6, through its op) on the card
    against the CPU, bit for bit:
    the hash at 4K under four salts, loop salts up to 2^32 - 1 among them;
    perlin3 on random, negative, lattice, large (above 2^24 and 2^31),
    NaN and infinite coordinates (NaN where the CPU has NaN). Prints what
    CUDA's own float -> int32 conversion gives where NumPy's gives
    INT_MIN, and the lattice index the port takes there."""
    from mathmap_tpu_torch.kernels import perlin3 as B6
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
    want = B6.perlin3(*cpu)
    got = B6.perlin3(*(c.to(dev) for c in cpu)).cpu()
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
          f"the port's lattice index on the card: {B6.lattice(sdev).cpu().tolist()}")


def phase_stochastic_path(mt, K, L, WL, dev, st) -> int:
    """The stochastic slice through Filter.render at 3840x2160: each
    render's (B1, B2, B3) launches as STOCHASTIC says, finite output of the
    frame's shape; then each at REDUCED size against the port's CPU render,
    bit for bit for BIT_EXACT, within RTOL, ATOL for the others, differing
    pixels counted. Returns B3's launches in the 4K renders."""
    zero_launches(LAUNCH_B1, LAUNCH_B2, LAUNCH_B3)
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3)
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
    wrappers = (LAUNCH_B1, LAUNCH_B4, LAUNCH_B3)
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
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3)
    mandel, twirl = filters["mandelbrot"], filters["twirl"]
    params = batch_params()
    frames = [0.0] * BATCH_JOBS
    builds, launchers = nvcc_builds(), len(WL._LAUNCHERS)
    before = launch_counts(*wrappers)
    out = mandel.render_batch(width=w, height=h, params=params, frames=frames, device=dev)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
    tag = f"batch mandelbrot {w}x{h} {BATCH_JOBS} jobs"
    if counts != (0, BATCH_JOBS, BATCH_JOBS):
        raise AssertionError(f"{tag}: (B1, B2, B3) launches {counts}")
    if (nvcc_builds(), len(WL._LAUNCHERS)) != (builds, launchers):
        raise AssertionError(f"{tag}: the batch built its loop again")
    if tuple(out.shape) != (BATCH_JOBS, h, w, 4) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: bad output {tuple(out.shape)}")
    lone = [mandel.render(width=w, height=h, params=p, device=dev) for p in params]
    differ = equal_jobs(out, lone)
    if differ:
        raise AssertionError(f"{tag}: {differ} jobs differ from their lone renders")
    print(f"{tag} (zoom 1..3 on the cardioid's boundary): (B1, B2, B3) launches {counts}, "
          f"nvcc builds {builds} before and after; every job equals its lone render "
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
    before = launch_count(LAUNCH_B1)
    out = f.render_animation(img, num_frames=n, options=opts, device=dev)
    torch.cuda.synchronize()
    launches = launch_count(LAUNCH_B1) - before
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
    before = launch_count(LAUNCH_B1)
    out = ident.render_animation(stack, num_frames=T, options=near, device=dev)
    torch.cuda.synchronize()
    if launch_count(LAUNCH_B1) - before != T or not torch.equal(out, want):
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
    before = launch_count(LAUNCH_B1)
    out = plane.render(stack, device=dev)
    torch.cuda.synchronize()
    if launch_count(LAUNCH_B1) != before:
        raise AssertionError("per-pixel frame plane: the gather route launched B1")
    # the independent version: B1 on each selected frame at the warp's
    # coordinates, chosen per pixel by the plane's selector
    xs = torch.arange(w, dtype=torch.float32, device=dev) + (0.5 - w / 2)
    ys = (h / 2 - 0.5) - torch.arange(h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    wx = (gx * 0.9 + 1.3).contiguous()
    wy = (gy * 0.8 - 0.7).contiguous()
    opts = mt.RenderOptions()
    counted = launch_count(LAUNCH_B1)
    by_frame = {k: K.sample_image(stack[k], wx, wy, opts.interpolation, opts.edge_x,
                                  opts.edge_y, opts.edge_color).permute(1, 2, 0)
                for k in (0, 2)}
    set_launches(LAUNCH_B1, counted)  # comparison launches are not the path's
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
        before = launch_count(LAUNCH_B1)
        out = f.render_sharded(stack, mesh=card_mesh(mt, dev, shape), num_frames=n)
        torch.cuda.synchronize()
        launches = launch_count(LAUNCH_B1) - before
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
    before = launch_count(LAUNCH_B4)
    errs, n_px = [], 0
    with KernelCapture(sampling, "tiled_kernel") as cap:
        for i in range(n):
            out = f.render_tiled(stack, mesh=mesh, t=0.3, frame=float(i))
            want = f.render(stack, t=0.3, frame=float(i), device=dev)
            errs.append(check_close(f"render_tiled animated frame {i}", out, want))
            n_px += int((out != want).any(-1).sum())
    torch.cuda.synchronize()
    launches = launch_count(LAUNCH_B4) - before
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


#: the library slice's entries that waited on the vector, matrix,
#: quaternion and special builtins (ROADMAP A7) and gaussian_blur (A2)
LIBRARY_ENTRIES = ("affine", "rotate", "sharpen", "gamma_spiral", "elliptic_rings",
                   "quat_julia")
#: gaussian_blur's stddev in the timed 4K blur (sharpen's)
BLUR_SIGMA = 1.5
#: a composition's pixels that may lie beyond RTOL, ATOL of the CPU
#: render: tests/test_library.py::test_composition_gallery_renders's bound
#: (2% of pixels beyond 2e-4) for a pixel on a discontinuity, where a warp
#: coordinate an ulp away (the card's libm) crosses it: psycho_fold's
#: solarize branches at 0.4, which is the u8 level 102/255 exactly
GALLERY_FRACTION = 0.02


def library_filters(mt) -> dict:
    """name -> Filter from the port's default_db(): LIBRARY_ENTRIES, then
    the compositions (filters/Compositions/*.mmc) in name order."""
    db = mt.default_db()
    if db.errors:
        raise AssertionError(f"default_db(): {db.errors}")
    names = LIBRARY_ENTRIES + tuple(sorted(db.categories["Compositions"]))
    return {n: db.compile(n) for n in names}


def library_inputs(f, w: int, h: int, dev, seed: int) -> list:
    """Smooth seeded u8 images on `dev`, one per image parameter of `f`
    (smooth_image: the card is held against the CPU)."""
    return [torch.from_numpy(smooth_image(w, h, seed=seed + i)[1]).to(dev)
            for i in range(len(f.image_params))]


def kernel_calls(sampling, color_ops, tracer, render) -> tuple:
    """(B1, B2, B3) wrapper calls of `render()`: on the CPU, the calls that
    the card turns into launches."""
    caps = (KernelCapture(sampling, "sample_kernel"), KernelCapture(color_ops, "apply_lut"),
            KernelCapture(tracer, "loop_kernel"))
    with caps[0], caps[1], caps[2]:
        render()
    return tuple(len(c.calls) for c in caps)


def phase_library_path(mt, K, L, WL, build, sampling, color_ops, tracer, dev, lib):
    """The library slice through default_db().compile(name): at REDUCED
    size each entry's (B1, B2, B3) calls on the CPU, then the card's render
    of the same inputs with those launches, within RTOL, ATOL of the CPU
    render (pixels beyond counted; a composition may have fewer than
    GALLERY_FRACTION of them; all failures listed at once); then each
    at 3840x2160 on the card with the same launches and finite output of
    the frame's shape. quat_julia: its loop takes the kernel route with no
    new nvcc build (phase 1 built it) and its carried grids, the iteration
    counts among them, equal the eager loop's on the same card tensors.
    Returns quat_julia's 4K B3 launches and its kernel's max abs err against
    the eager loop."""
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3)
    builds = nvcc_builds()
    failures, expected = [], {}
    w, h = REDUCED
    for name, f in lib.items():
        inputs = library_inputs(f, w, h, "cpu", seed=70)
        size = dict(width=w, height=h, t=0.3)
        want = None

        def cpu():
            nonlocal want
            want = f.render(*inputs, device="cpu", **size)

        expected[name] = kernel_calls(sampling, color_ops, tracer, cpu)
        before = launch_counts(*wrappers)
        got = f.render(*(a.to(dev) for a in inputs), device=dev, **size)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
        got = got.cpu()
        beyond = (got - want).abs() > ATOL + RTOL * want.abs()
        n_px, n_beyond = int((got != want).any(-1).sum()), int(beyond.any(-1).sum())
        err = float((got - want).abs().max())
        tag = f"library {name:16s} {w}x{h} card vs CPU"
        print(f"{tag}: (B1, B2, B3) launches {counts}, CPU calls {expected[name]}; max abs "
              f"err {err:.3e}, {n_px} pixels differ, {n_beyond} beyond rtol={RTOL}, "
              f"atol={ATOL}")
        if counts != expected[name]:
            failures.append(f"{tag}: launches {counts}, expected {expected[name]}")
        allowed = 0 if name in LIBRARY_ENTRIES else GALLERY_FRACTION * w * h
        if n_beyond > allowed:
            failures.append(f"{tag}: {n_beyond} pixels beyond tolerance ({allowed:g} "
                            f"allowed), max abs err {err:.3e}")
    w, h = SIZES[1]
    qj_launches, qj_err = 0, None
    for name, f in lib.items():
        inputs = library_inputs(f, w, h, dev, seed=80)
        before, loops_before = launch_counts(*wrappers), loop_routes()
        with LoopCapture(tracer) as cap:
            out = f.render(*inputs, width=w, height=h, t=0.3, device=dev)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
        tag = f"library {name:16s} {w}x{h}"
        if counts != expected[name]:
            failures.append(f"{tag}: (B1, B2, B3) launches {counts}, expected {expected[name]}")
        if tuple(out.shape) != (h, w, 4) or not bool(torch.isfinite(out).all()):
            failures.append(f"{tag}: bad or non-finite output {tuple(out.shape)}")
        routes = {r: n - loops_before.get(r, 0) for r, n in loop_routes().items()
                  if n != loops_before.get(r, 0)}
        line = f"{tag}: (B1, B2, B3) launches {counts}, loop routes {routes}"
        if name == "quat_julia":
            qj_launches = counts[2]
            loop, flat0, mask0, max_iters, got = cap.one(name)
            want, steps, iters = loop_reference(WL, loop, flat0, mask0, max_iters)
            torch.cuda.synchronize()
            differ = sum(int((a != b).sum()) for a, b in zip(got, want))
            qj_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            line += (f"; B3 vs the eager loop: {len(flat0)} carried grids, {iters} pixel "
                     f"iterations in {steps} steps, {differ} values differ, max abs err "
                     f"{qj_err:.3e}")
            if routes != {"kernel": 1} or differ:
                failures.append(f"{tag}: routes {routes}, {differ} carried values differ "
                                f"from the eager loop (kernel route, identical required)")
        print(line)
    if nvcc_builds() != builds:
        failures.append(f"library path: {nvcc_builds() - builds} nvcc builds after "
                        f"phase 1, none expected")
    if failures:
        raise AssertionError("library path:\n  " + "\n  ".join(failures))
    print(f"library path: {len(lib)} entries ({len(LIBRARY_ENTRIES)} .mm, "
          f"{len(lib) - len(LIBRARY_ENTRIES)} compositions) at {REDUCED[0]}x{REDUCED[1]} "
          f"against the CPU and at {w}x{h}; no nvcc build after phase 1")
    return qj_launches, qj_err


def time_gaussian_blur(NF, dev, card):
    """gaussian_blur's route at 4K (u8 source, BLUR_SIGMA) beside F.conv2d
    computing the same separable blur, zero padding and mask
    renormalisation with TF32 off (cuDNN's default on Hopper is TF32);
    the bound moves the u8 image in and the float32 blur out once."""
    import torch.nn.functional as F

    w, h = SIZES[1]
    u8 = torch.from_numpy(seeded_image(w, h, seed=17)[1]).to(dev)
    sigma, r = NF.blur_radius(BLUR_SIGMA)
    k = torch.tensor(NF.gauss_kernel(sigma, r), device=dev)

    def conv():
        img = (u8.to(torch.float32) / torch.tensor(255.0, device=dev)).permute(2, 0, 1)
        both = torch.cat([img, torch.ones_like(img[:1])])[:, None]
        both = F.conv2d(F.conv2d(both, k.view(1, 1, 1, -1), padding=(0, r)),
                        k.view(1, 1, -1, 1), padding=(r, 0))[:, 0]
        return (both[:4] / both[4:]).permute(1, 2, 0)

    route = lambda: NF.gaussian_blur_pixels(u8, BLUR_SIGMA)  # noqa: E731
    route_ms, conv_ms = turns(conv, route, 5, 5)
    diff = float((route() - conv()).abs().max())
    n_bytes = u8.numel() + 4 * u8.numel()
    # a multiply and an add a tap (an FMA, 2 ops at FP32_OPS_PER_S): the 4
    # channels in both passes and the mask's y pass; then 4 divisions
    n_ops = h * w * ((4 * 2 + 1) * 2 * (2 * r + 1) + 4)
    bound, by = bound_ms(n_bytes, n_ops)
    print(f"timing gaussian_blur {w}x{h} u8 sigma={BLUR_SIGMA} (radius {r}): shifted-slice "
          f"route {route_ms:.4f} ms, F.conv2d (TF32 off) {conv_ms:.4f} ms, max abs diff "
          f"{diff:.2e}; bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.0f} MB); no TPU kernel "
          f"[{card}]")


def time_library(lib, dev, card):
    """Median fenced 4K renders of the library slice."""
    w, h = SIZES[1]
    for name, f in lib.items():
        inputs = library_inputs(f, w, h, dev, seed=80)
        ms = fenced_median_ms(lambda: f.render(*inputs, width=w, height=h, t=0.3, device=dev))
        print(f"timing render {name:16s} {w}x{h}{' u8 in' if inputs else ''}: median "
              f"{ms:.3f} ms/frame of {TIMED_RENDERS}, {w * h / ms / 1e3:.1f} Mpix/s [{card}]")


#: the front-end slice (region, corners, CLI, service, --selftest): an
#: unaligned 4K selection (x, y, w, h), 28.1% of the frame
REGION = (517, 263, 1931, 1207)
#: the tiled region's mesh of cuda:0 and its pond halo
REGION_MESH = (1, 4, 1)
#: the service phase's concurrent /render requests (twirl 1080p, one u8
#: image, one angle each)
SERVE_REQUESTS = 16
SELFTEST_LOOP = ("filter selftest_loop () i = 0; z = ri:[x / 64, y / 64]; c = z;"
                 " while abs(z) < 2 && i < 12 do z = z * z + c; i = i + 1 end;"
                 " grayColor(i / 12) end")


def crop(full, region):
    x, y, w, h = region
    return full[y:y + h, x:x + w]


def region_mask(h: int, w: int, region, dev):
    mask = torch.zeros(h, w, 1, dtype=torch.bool, device=dev)
    x, y, rw, rh = region
    mask[y:y + rh, x:x + rw] = True
    return mask


def phase_region(mt, K, L, WL, B4, dev, filters, st):
    """Region renders at 3840x2160 on the card, each against the card's full
    render cropped, bit for bit, with the full render's kernels launched on
    the region's grid: fisheye and twirl (u8 in; float32 and uint8 out; B1),
    mandelbrot (B3, B2), static_tv (rand(), B1) and rand_walk (rand() in B3);
    then pond's tiled region on a (1,4,1) mesh of cuda:0 (u8 in, float32 and
    uint8 out): inside, the unsharded region render (rtol=1e-4, atol=1e-5;
    uint8 within 1 LSB), outside, input 0 bit for bit (uint8 out: its bytes;
    float32 out: u8/255); one B4 launch a tile that meets the region."""
    w, h = SIZES[1]
    _, u8 = smooth_image(w, h, seed=21)
    img = torch.from_numpy(u8).to(dev)
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3)
    cases = [(name, [img], {}, out) for name in ("fisheye", "twirl")
             for out in ("float32", "uint8")]
    cases += [("mandelbrot", [], {}, "float32"), ("mandelbrot", [], {}, "uint8"),
              ("static_tv", [img], {}, "float32"), ("rand_walk", [], {}, "float32")]
    for name, ins, params, out_dtype in cases:
        f = filters.get(name) or st[name]
        full = f.render(*ins, width=w, height=h, params=params, device=dev,
                        options=mt.RenderOptions(output_dtype=out_dtype))
        before = launch_counts(*wrappers)
        got = f.render(*ins, width=w, height=h, params=params, device=dev,
                       options=mt.RenderOptions(output_dtype=out_dtype, region=REGION))
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(launch_counts(*wrappers), before))
        want = {"mandelbrot": (0, 1, 1), "rand_walk": (0, 0, 1)}.get(name, (1, 0, 0))
        tag = f"region {name} {w}x{h} {REGION} {out_dtype} out"
        if launched != want:
            raise AssertionError(f"{tag}: (B1, B2, B3) launches {launched}, expected {want}")
        if tuple(got.shape) != (REGION[3], REGION[2], 4):
            raise AssertionError(f"{tag}: shape {tuple(got.shape)}")
        if not torch.equal(got, crop(full, REGION)):
            n = int((got != crop(full, REGION)).any(-1).sum())
            raise AssertionError(f"{tag}: {n} pixels differ from the full render's crop")
        print(f"{tag}: equal to the full render's crop bit for bit; (B1, B2, B3) "
              f"launches {launched}")
    f = filters["pond"]
    mesh = card_mesh(mt, dev, REGION_MESH)
    mask = region_mask(h, w, REGION, dev)
    for out_dtype in ("float32", "uint8"):
        o = mt.RenderOptions(region=REGION, output_dtype=out_dtype)
        before = launch_count(LAUNCH_B4)
        got = f.render_tiled(img, mesh=mesh, options=o)
        torch.cuda.synchronize()
        tiles = launch_count(LAUNCH_B4) - before
        lone = f.render(img, options=o, device=dev)
        tag = f"region pond tiled {REGION_MESH} {w}x{h} {REGION} {out_dtype} out"
        th = h // REGION_MESH[1]
        meets = sum(1 for r in range(REGION_MESH[1])
                    if r * th < REGION[1] + REGION[3] and REGION[1] < (r + 1) * th)
        if tiles != meets:
            raise AssertionError(f"{tag}: {tiles} B4 launches, expected {meets}")
        bg = img if out_dtype == "uint8" else K.u8_to_float(img)
        if not torch.equal(torch.where(mask, bg, got), bg):
            raise AssertionError(f"{tag}: a pixel outside the selection is not input 0's")
        inside = crop(got, REGION)
        if out_dtype == "uint8":
            err = int((inside.int() - lone.int()).abs().max())
            if err > 1:
                raise AssertionError(f"{tag}: {err} LSB from the unsharded region render")
        else:
            err = check_close(tag, inside, lone)
        print(f"{tag}: {tiles} B4 launches (the tiles that meet the selection); inside "
              f"max err {err} vs the unsharded region render; outside input 0 bit for bit")


def phase_corners(mt, K, dev, filters):
    """supersample=2 under supersample_scheme='corners': ripple at 1920x1080
    on a smooth u8 image, two B1 launches a frame (the (h+1, w+1) corner
    grid, then the centres), finite; at 480x270 against the port's CPU
    render (rtol=1e-4, atol=1e-5), and the same with a region inside it
    equal to its full render's crop bit for bit."""
    f = filters["ripple"]
    o = mt.RenderOptions(supersample=2, supersample_scheme="corners")
    w, h = SIZES[0]
    img = torch.from_numpy(smooth_image(w, h, seed=15)[1]).to(dev)
    before = launch_count(LAUNCH_B1)
    out = f.render(img, options=o, device=dev)
    torch.cuda.synchronize()
    if launch_count(LAUNCH_B1) - before != 2:
        raise AssertionError(f"corners ripple {w}x{h}: {launch_count(LAUNCH_B1) - before} "
                             f"B1 launches, expected 2")
    if tuple(out.shape) != (h, w, 4) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"corners ripple {w}x{h}: bad output")
    rw, rh = REDUCED
    _, small = smooth_image(rw, rh, seed=15)
    got = f.render(torch.from_numpy(small).to(dev), options=o, device=dev)
    err = check_close(f"corners ripple {rw}x{rh} vs the CPU", got.cpu(),
                      f.render(small, options=o, device="cpu"))
    reg = (rw // 13, rh // 13, rw * 5 // 8, rh * 4 // 7)  # unaligned, inside
    sub = f.render(torch.from_numpy(small).to(dev), device=dev, options=mt.RenderOptions(
        supersample=2, supersample_scheme="corners", region=reg))
    if not torch.equal(sub, crop(got, reg)):
        raise AssertionError(f"corners ripple {rw}x{rh} region {reg}: not the crop")
    print(f"corners ripple {w}x{h} supersample=2: 2 B1 launches, finite; {rw}x{rh} vs the "
          f"CPU render max abs err {err:.3e}; region {reg} equal to the crop bit for bit")


def _cli_png(path) -> torch.Tensor:
    from mathmap_tpu_torch.imgio.images import read_animation

    return torch.from_numpy(read_animation(str(path), as_uint8=True)[0])


def phase_cli(mt, K, B4, dev, work: Path):
    """cli.main in-process on the card over a 1920x1080 PNG (smooth, u8),
    each written PNG equal to the API's render of the decoded input packed
    to uint8 on the card, bit for bit: one twirl frame; ripple --frames 3
    (frame i at t = i/3); --input-dir over 3 images (--batch-size 2, frame
    0); --param-sweep angle=1:5 over 3 frames (frame i); pond --tiled
    --region (the (1,1,1) mesh of the one card, the selection in place).
    Then one `python -m mathmap_tpu_torch` subprocess, its wall time
    printed."""
    from mathmap_tpu_torch import cli
    from mathmap_tpu_torch.imgio.images import read_image, write_image

    w, h = SIZES[0]
    src = work / "in.png"
    write_image(str(src), smooth_image(w, h, seed=23)[1])
    inp = read_image(str(src))
    u8 = mt.RenderOptions(output_dtype="uint8")
    twirl = str(ROOT / "filters" / "Distorts" / "twirl.mm")
    ripple = str(ROOT / "filters" / "Distorts" / "ripple.mm")
    pond = str(ROOT / "filters" / "Distorts" / "pond.mm")
    f_tw, f_rip, f_pond = (mt.compile_file(p) for p in (twirl, ripple, pond))

    def same(tag, path, want):
        got = _cli_png(path)
        if not torch.equal(got, want.cpu()):
            n = int((got != want.cpu()).any(-1).sum())
            raise AssertionError(f"cli {tag}: {n} pixels differ from the API's u8 render")

    def run(argv):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv}: exit {rc}")
        return (time.perf_counter() - t0) * 1e3

    ms = run([twirl, str(src), str(work / "tw.png"), "--param", "angle=4"])
    same("one frame", work / "tw.png", f_tw.render(inp, params={"angle": 4}, options=u8,
                                                   device=dev))
    print(f"cli twirl {w}x{h} PNG in and out: {ms:.1f} ms in cli.main, equal to the API's u8 "
          f"render bit for bit")
    run([ripple, str(src), str(work / "rip.png"), "--frames", "3"])
    for i, t in enumerate(np.arange(3, dtype=np.float32) / 3):
        same(f"--frames 3 frame {i}", work / f"rip_{i:04d}.png",
             f_rip.render(inp, t=float(t), frame=float(i), options=u8, device=dev))
    ind = work / "ins"
    ind.mkdir()
    for k in range(3):
        write_image(str(ind / f"img{k}.png"), smooth_image(w, h, seed=30 + k)[1])
    run([twirl, str(work / "outs"), "--input-dir", str(ind), "--batch-size", "2"])
    for k in range(3):
        same(f"--input-dir img{k}", work / "outs" / f"img{k}.png",
             f_tw.render(read_image(str(ind / f"img{k}.png")), options=u8, device=dev))
    run([twirl, str(src), str(work / "sw.png"), "--param-sweep", "angle=1:5", "--frames", "3"])
    for i, a in enumerate((1.0, 3.0, 5.0)):
        same(f"--param-sweep step {i}", work / f"sw_{i:04d}.png",
             f_tw.render(inp, frame=float(i), params={"angle": a}, options=u8, device=dev))
    reg = (w // 6 + 1, h // 9 + 3, w // 2 - 7, h // 2 + 5)  # unaligned
    before = launch_count(LAUNCH_B4)
    run([pond, str(src), str(work / "tr.png"), "--tiled", "--region",
         f"{reg[0]},{reg[1]},{reg[2]}x{reg[3]}"])
    if launch_count(LAUNCH_B4) == before:
        raise AssertionError("cli --tiled --region: no B4 launch")
    same("--tiled --region", work / "tr.png", f_pond.render_tiled(
        inp, mesh=mt.make_mesh(), options=mt.RenderOptions(region=reg, output_dtype="uint8")))
    print("cli --frames 3, --input-dir (3 images, --batch-size 2), --param-sweep (3 steps), "
          "--tiled --region: every PNG equal to the API's u8 render bit for bit")
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "PYTHONPATH": str(ROOT),
           "HOME": str(work), "TMPDIR": str(work)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mathmap_tpu_torch", twirl, str(src),
                           str(work / "sub.png"), "--param", "angle=4", "-v"],
                          capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m mathmap_tpu_torch: exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    same("subprocess", work / "sub.png", f_tw.render(inp, params={"angle": 4}, options=u8,
                                                     device=dev))
    print(f"cli subprocess `python -m mathmap_tpu_torch` twirl {w}x{h}: {wall:.2f} s wall "
          f"(interpreter, torch import, kernel library load, render); its -v: "
          + " | ".join(proc.stderr.strip().splitlines()))


def time_cli_frame(mt, dev, work: Path, card):
    """A CLI frame of twirl 1920x1080 split into its parts, each the median
    of 5: decode (read_image of the PNG), render (float32 input uploaded and
    rendered, output copied to the host, fenced), encode (write_image); and
    cli.main over the whole frame."""
    from mathmap_tpu_torch import cli
    from mathmap_tpu_torch.imgio.images import read_image, write_image

    src, out = work / "in.png", work / "t.png"
    twirl = str(ROOT / "filters" / "Distorts" / "twirl.mm")
    f = mt.compile_file(twirl)

    def med(call):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    inp = read_image(str(src))
    frame = f.render(inp, params={"angle": 4}, device=dev).cpu()
    decode = med(lambda: read_image(str(src)))
    render = med(lambda: f.render(inp, params={"angle": 4}, device=dev).cpu())
    encode = med(lambda: write_image(str(out), frame))
    whole = med(lambda: cli.main([twirl, str(src), str(out), "--param", "angle=4"]))
    print(f"timing cli frame twirl {SIZES[0][0]}x{SIZES[0][1]} PNG: decode {decode:.2f} ms, "
          f"render {render:.2f} ms (upload, render, readback), encode {encode:.2f} ms; "
          f"cli.main {whole:.2f} ms [{card}]")


def phase_serve(mt, K, dev, card):
    """RenderService on cuda:0 (its defaults: window 4 ms, max_batch 32)
    behind the HTTP server on 127.0.0.1: one warmup, then SERVE_REQUESTS
    concurrent /render requests of twirl 1920x1080 at as many angles over one
    u8 PNG; every reply (a PNG) equal to its lone render on the card, bit
    for bit; the batch histogram, p50/p99 latency and requests/s printed."""
    import base64
    import urllib.request
    from http.server import ThreadingHTTPServer

    from mathmap_tpu_torch.imgio.png import decode_png, encode_png
    from mathmap_tpu_torch.serve import RenderService, make_handler

    w, h = SIZES[0]
    _, u8 = smooth_image(w, h, seed=25)
    body = base64.b64encode(encode_png(u8)).decode()
    angles = [float(a) for a in np.linspace(-7.5, 7.5, SERVE_REQUESTS)]
    svc = RenderService(device=dev)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(req):
        r = urllib.request.Request(base + "/render", json.dumps(req).encode(),
                                   headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(r, timeout=300) as resp:
            data = resp.read()
        return data, (time.perf_counter() - t0) * 1e3

    try:
        svc.warmup("twirl", w, h, batch_sizes=(1,))
        launches = launch_count(LAUNCH_B1)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_REQUESTS) as pool:
            replies = list(pool.map(post, [
                {"filter": "twirl", "width": w, "height": h, "params": {"angle": a},
                 "inputs": [body], "binary": True} for a in angles]))
        wall = time.perf_counter() - t0
        stats = svc.snapshot()
        launches = launch_count(LAUNCH_B1) - launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()
    f = mt.default_db().compile("twirl")
    img = torch.from_numpy(u8).to(dev)
    for a, (data, _) in zip(angles, replies):
        lone = f.render(img, params={"angle": a}, device=dev,
                        options=mt.RenderOptions(output_dtype="uint8")).cpu().numpy()
        if not np.array_equal(decode_png(data), lone):
            raise AssertionError(f"serve twirl angle={a}: reply differs from its lone render")
    if launches != SERVE_REQUESTS:
        raise AssertionError(f"serve: {launches} B1 launches for {SERVE_REQUESTS} requests")
    lat = np.array([ms for _, ms in replies])
    print(f"serve {SERVE_REQUESTS} concurrent /render twirl {w}x{h} (u8 PNG in and out): "
          f"every reply equal to its lone render bit for bit; {launches} B1 launches; "
          f"batch_hist {stats['batch_hist']}, {stats['dispatches']} dispatches; latency p50 "
          f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms; "
          f"{SERVE_REQUESTS / wall:.2f} requests/s ({wall * 1e3:.1f} ms wall) [{card}]")


def phase_selftest(mt, dev):
    from mathmap_tpu_torch.selftest import run_selftest

    failures = run_selftest(device=dev)
    if failures:
        raise AssertionError(f"selftest: {failures} failure(s)")


def time_region_corners(mt, dev, filters, st, card):
    """Region against full (twirl u8 and mandelbrot at 4K), and a corners
    frame against a plain and a grid supersample=2 frame (ripple 1080p):
    fenced medians of 20 renders."""
    w, h = SIZES[1]
    img = torch.from_numpy(smooth_image(w, h, seed=21)[1]).to(dev)
    frac = REGION[2] * REGION[3] / (w * h)
    for name, ins in (("twirl", [img]), ("mandelbrot", [])):
        f = filters[name]
        full = fenced_median_ms(lambda: f.render(*ins, width=w, height=h, device=dev))
        reg = fenced_median_ms(lambda: f.render(*ins, width=w, height=h, device=dev,
                                                options=mt.RenderOptions(region=REGION)))
        print(f"timing region {name} {w}x{h} {REGION} ({100 * frac:.1f}% of the frame): "
              f"{reg:.3f} ms against the full render's {full:.3f} ms ({reg / full:.3f}x) "
              f"[{card}]")
    w, h = SIZES[0]
    img = torch.from_numpy(smooth_image(w, h, seed=15)[1]).to(dev)
    f = filters["ripple"]
    times = {label: fenced_median_ms(lambda o=o: f.render(img, options=o, device=dev))
             for label, o in (("plain", mt.RenderOptions()),
                              ("corners ss2", mt.RenderOptions(
                                  supersample=2, supersample_scheme="corners")),
                              ("grid ss2", mt.RenderOptions(supersample=2)))}
    plain = times["plain"]
    print(f"timing ripple {w}x{h}: plain {plain:.3f} ms, corners supersample=2 "
          f"{times['corners ss2']:.3f} ms ({times['corners ss2'] / plain:.2f}x), grid "
          f"supersample=2 {times['grid ss2']:.3f} ms ({times['grid ss2'] / plain:.2f}x) "
          f"[{card}]")


#: the curve filter of tests/test_generators.py (B2 on a curve param)
CURVE_SRC = ("filter c (image in, curve cv) "
             "grayColor(cv(clamp(abs(x / X), 0, 1))) end")
#: a loop whose body reads `t` and `W`: in an artifact its kernel takes
#: them from device memory (the export's `t` input), live by value
T_LOOP = ("filter tloop () s = 0; i = 0; while s < 1 + t && i < 60 do "
          "s = s + 0.02 + x / W * 0.01; i = i + 1 end; grayColor(i / 60) end")
ARTIFACT_JOBS = 4
PREVIEW_ROUND_TRIPS = 5
#: the composer graph of tests/test_preview.py
PREVIEW_GRAPH = {
    "nodes": [
        {"id": "a", "filter": "grayscale", "params": {"in": {"input": 0}}},
        {"id": "b", "filter": "twirl", "params": {"in": {"ref": "a"}, "angle": 5.0}},
    ],
    "output": "b",
}
DISTRIBUTED_RANKS = 2
DISTRIBUTED_TILES = 2  # mesh rows each rank contributes, all on cuda:0
DISTRIBUTED_SEED = 46  # the fleet's 4K u8 image
DISTRIBUTED_TIMED = 5  # fenced tiled frames timed on each rank
TIMING_GO = "timing.go"  # written when the fleet may time its frames


def launched(K, L, WL, call):
    """(result of call(), its (B1, B2, B3) launches)."""
    before = (launch_count(LAUNCH_B1), launch_count(LAUNCH_B2), launch_count(LAUNCH_B3))
    out = call()
    torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(before, (
        launch_count(LAUNCH_B1), launch_count(LAUNCH_B2), launch_count(LAUNCH_B3))))


def phase_artifact(mt, K, L, WL, build, dev, filters, work: Path, card):
    """Exported artifacts on the card at 3840x2160: twirl (B1), the curve
    filter (B2), default mandelbrot (B3, B2) and T_LOOP (B3 with its
    scalars `t` and `W` in device memory), each exported with
    export_artifact on cuda:0 and loaded with load_artifact; render launches
    each kernel once through its custom op and equals the live card render
    bit for bit, and render_batch (4 jobs) and render_animation (4 frames)
    equal the live ones; then a CLI .mmxa frame and one artifact request
    through the service. Timings: export and load seconds (mandelbrot's
    load with its B3 library rebuilt by nvcc and without), the artifact
    render against the live one (fenced medians of 20)."""
    from mathmap_tpu_torch import cli
    from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
    from mathmap_tpu_torch.imgio.images import to_uint8, write_image
    from mathmap_tpu_torch.serve import RenderService

    w, h = SIZES[1]
    _, u8 = smooth_image(w, h, seed=41)
    img_u8 = torch.from_numpy(u8).to(dev)
    img = K.u8_to_float(img_u8)
    lut = torch.from_numpy((np.linspace(0, 1, 16) ** 2).astype(np.float32))
    cases = {
        "twirl": (filters["twirl"], [img], {"angle": 3.0}, {"angle": 5.0}, (1, 0, 0)),
        "curve": (mt.compile(CURVE_SRC), [img], {"cv": lut}, {"cv": lut * 0.5}, (0, 1, 0)),
        "mandelbrot": (filters["mandelbrot"], [], {}, {}, (0, 1, 1)),
        "t loop": (mt.compile(T_LOOP), [], {}, {}, (0, 0, 1)),
    }
    for name, (f, ins, p_export, p, want_launches) in cases.items():
        path = work / f"{name}.mmxa"
        t0 = time.perf_counter()
        export_artifact(f, str(path), w, h, params=p_export, batch_sizes=(ARTIFACT_JOBS,),
                        anim_frames=ARTIFACT_JOBS, device=dev)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = load_artifact(str(path))
        load_s = time.perf_counter() - t0
        built = ""
        if art.loops and dev.type == "cuda":
            # load again with the loop's library gone: nvcc builds it
            sources = [WL.emit_cuda(WL.Program.from_text(t), json.loads(t)["origin"])
                       for t in art.loops]
            for src in sources:
                build.generated_paths(src)[1].unlink(missing_ok=True)
                WL._LAUNCHERS.pop(src, None)
            build.generated_library.cache_clear()
            builds = nvcc_builds()
            t0 = time.perf_counter()
            art = load_artifact(str(path))
            built_s = time.perf_counter() - t0
            if nvcc_builds() != builds + len(sources):
                raise AssertionError(f"artifact {name}: load built "
                                     f"{nvcc_builds() - builds} loop kernels")
            built = f", {built_s:.2f} s with its B3 library built by nvcc"
        got, launches = launched(K, L, WL, lambda: art.render(*ins, params=p, t=0.3))
        want = f.render(*ins, params=p, t=0.3, width=w, height=h, device=dev)
        if not torch.equal(got, want):
            raise AssertionError(f"artifact {name}: render differs from the live render")
        if launches != want_launches:
            raise AssertionError(f"artifact {name}: (B1, B2, B3) launches {launches}, "
                                 f"expected {want_launches}")
        ts = [0.1 * i for i in range(ARTIFACT_JOBS)]
        stacks = [torch.stack([a] * ARTIFACT_JOBS) for a in ins]
        jobs = [p] * ARTIFACT_JOBS
        got = art.render_batch(*stacks, params=jobs, ts=ts)
        want = f.render_batch(*stacks, ts=ts, params=jobs, width=w, height=h, device=dev)
        if not torch.equal(got, want):
            raise AssertionError(f"artifact {name}: render_batch differs from the live one")
        got = art.render_animation(*ins, params=p)
        want = f.render_animation(*ins, num_frames=ARTIFACT_JOBS, params=p, width=w,
                                  height=h, device=dev)
        if not torch.equal(got, want):
            raise AssertionError(f"artifact {name}: render_animation differs from the live one")
        art_ms = fenced_median_ms(lambda: art.render(*ins, params=p, t=0.3))
        live_ms = fenced_median_ms(lambda: f.render(*ins, params=p, t=0.3, width=w, height=h,
                                                    device=dev))
        print(f"artifact {name} {w}x{h}: export {export_s:.2f} s, load {load_s:.2f} s{built}; "
              f"render launches (B1, B2, B3) {launches} through the mathmap:: ops, equal to "
              f"the live render bit for bit, render_batch ({ARTIFACT_JOBS} jobs) and "
              f"render_animation ({ARTIFACT_JOBS} frames) too; render {art_ms:.3f} ms against "
              f"the live render's {live_ms:.3f} ms [{card}]")
    src = work / "art_in.png"
    write_image(str(src), u8)
    p = {"angle": 5.0}
    if cli.main([str(work / "twirl.mmxa"), str(src), str(work / "art_out.png"), "--param",
                 "angle=5"]) != 0:
        raise AssertionError("artifact cli: non-zero exit")
    want = to_uint8(filters["twirl"].render(img, params=p, device=dev).cpu().numpy())
    if not torch.equal(_cli_png(work / "art_out.png"), torch.from_numpy(want)):
        raise AssertionError("artifact cli: the PNG differs from the live render's")
    svc = RenderService(device=dev)
    try:
        svc.load_artifacts(str(work / "twirl.mmxa"))
        got, launches = launched(K, L, WL, lambda: svc.render_artifact("twirl", [u8], params=p))
    finally:
        svc.shutdown()
    want = filters["twirl"].render(img, params=p, device=dev).cpu().numpy()
    if not np.array_equal(got, want) or launches != (1, 0, 0):
        raise AssertionError(f"artifact service request: equal {np.array_equal(got, want)}, "
                             f"launches {launches}")
    print("artifact twirl: a CLI .mmxa frame (PNG in and out) equal to the live render's PNG, "
          "and one service request (RenderService.render_artifact, one B1 launch) equal to "
          "the live render bit for bit")


#: a feedback loop over the input image: a runtime int trip count (per
#: pixel through x * 0), origVal at a scaled xy every step; B3 refuses the
#: body (it samples an image), so an artifact holds the loop as torch's
#: while loop with B1 inside
FEEDBACK = ("filter feedback (image in, int n: 0-20 (6), float k: 0-2 (0.97)) c = in(xy); "
            "i = 0; p = xy; while i < n + x * 0 do p = p * k; c = (c + in(p)) * 0.5; "
            "i = i + 1 end; c end")
#: rand() in a loop that B3 refuses (atan) inside a loop whose trip count is
#: a param: in an artifact both are while loops, and the inner draws are
#: salted with the outer iteration number, a tensor there
NESTED_RAND = ("filter nested_rand (int n: 1-9 (3)) s = 0; i = 0; while i < n do j = 0; "
               "while j < 2 + x * 0 do s = s + atan(rand(0, 1) + j); j = j + 1 end; "
               "i = i + 1 end; grayColor(s / 8) end")


def host_syncs(call) -> int:
    """cudaStreamSynchronize calls in one call() after a warm-up call
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.name == "cudaStreamSynchronize" for e in prof.events())


def phase_artifact_loops(mt, K, L, WL, dev, st, work: Path, card):
    """Artifacts of loops that kernel B3 refuses, at 3840x2160 on cuda:0:
    each loop is torch's while loop in the exported program
    (kernels/while_loop.py::while_loop_exported). ridged_noise (`octaves`
    and `scale` runtime inputs), FEEDBACK (B1 in the loop) and NESTED_RAND
    (tensor salts): every render, render_batch (4 jobs) and
    render_animation (4 frames) equal to the live card render bit for bit,
    each render with the (B1, B2, B3) launches of a cold live render (the
    exported program runs its loops' probes every time); FEEDBACK's B1 launches in the loop
    are its steps rounded up to whole while_unroll groups. Then fault C4:
    the Perlin table's cache was emptied before the exports, and a live
    turbulence render after them is a real CUDA tensor equal to the one
    taken before; ridged_noise exports again. Timings: export and load
    seconds, artifact and live fenced medians, syncs a render."""
    from torch._subclasses.fake_tensor import FakeTensor

    from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
    from mathmap_tpu_torch.kernels import perlin3 as B6

    w, h = SIZES[1]
    turbulence = st["turbulence"]
    small = dict(width=SIZES[0][0], height=SIZES[0][1], t=0.3, device=dev)
    before = turbulence.render(**small)
    # the Perlin table's cache empty, as in a process whose first noise call
    # is an export (fault C4's start; the op traces no table since B6)
    B6._table.cache_clear()
    _, u8 = smooth_image(w, h, seed=47)
    img = K.u8_to_float(torch.from_numpy(u8).to(dev))
    unroll = mt.RenderOptions().while_unroll
    # a filter compiled afresh: an exported program runs its loops' probes
    # on every render, a live Filter only until its loops' memos hold them
    # (runtime/loops.py::probe_outcome), so the launches are compared with
    # a cold live render's
    cases = (
        ("ridged_noise", lambda: mt.compile_file(str(ROOT / "filters" / "Noise" /
                                                     "ridged_noise.mm")), [], [
            {"octaves": o, "scale": s} for o, s in ((4, 120.0), (1, 120.0), (6, 120.0),
                                                      (4, 310.0))]),
        ("feedback", lambda: mt.compile(FEEDBACK), [img],
         [{"n": n, "k": 0.97} for n in (6, 0, 3, 13)]),
        ("nested rand", lambda: mt.compile(NESTED_RAND), [], [{"n": n} for n in (3, 1, 5)]),
    )
    for name, fresh, ins, settings in cases:
        f = fresh()
        path = work / f"{name.replace(' ', '_')}.mmxa"
        t0 = time.perf_counter()
        export_artifact(f, str(path), w, h, params=settings[0], batch_sizes=(ARTIFACT_JOBS,),
                        anim_frames=ARTIFACT_JOBS, device=dev)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = load_artifact(str(path))
        load_s = time.perf_counter() - t0
        n_loops = sum(n.target is torch.ops.higher_order.while_loop
                      for n in art._program.graph.nodes)
        if not n_loops:
            raise AssertionError(f"artifact {name}: no while_loop in the exported program")
        b1 = []
        for p in settings:
            got, launches = launched(K, L, WL, lambda: art.render(*ins, params=p, t=0.3))
            cold = fresh()
            want, live = launched(K, L, WL, lambda: cold.render(*ins, params=p, t=0.3, width=w,
                                                               height=h, device=dev))
            if not torch.equal(got, want):
                raise AssertionError(f"artifact {name} {p}: render differs from the live one")
            if launches != live:
                raise AssertionError(f"artifact {name} {p}: (B1, B2, B3) launches {launches}, "
                                     f"the live render's {live}")
            b1.append(launches[0])
        if name == "feedback":
            # n = 0 runs no step: its launches are the ones outside the loop
            outside = b1[[p["n"] for p in settings].index(0)]
            steps = {p["n"]: c - outside for p, c in zip(settings, b1)}
            for n, c in steps.items():
                if c != -(-n // unroll) * unroll:
                    raise AssertionError(f"artifact feedback n={n}: {c} B1 launches in the "
                                         f"loop, expected {-(-n // unroll) * unroll}")
            print(f"artifact feedback {w}x{h}: B1 launches inside the exported loop by trip "
                  f"count n {steps} (while_unroll {unroll}; {outside} outside it)")
        p = settings[0]
        ts = [0.1 * i for i in range(ARTIFACT_JOBS)]
        stacks = [torch.stack([a] * ARTIFACT_JOBS) for a in ins]
        jobs = [p] * ARTIFACT_JOBS
        got = art.render_batch(*stacks, params=jobs, ts=ts)
        want = f.render_batch(*stacks, ts=ts, params=jobs, width=w, height=h, device=dev)
        if not torch.equal(got, want):
            raise AssertionError(f"artifact {name}: render_batch differs from the live one")
        got = art.render_animation(*ins, params=p)
        want = f.render_animation(*ins, num_frames=ARTIFACT_JOBS, params=p, width=w,
                                  height=h, device=dev)
        if not torch.equal(got, want):
            raise AssertionError(f"artifact {name}: render_animation differs from the live one")

        def art_render():
            return art.render(*ins, params=p, t=0.3)

        def live_render():
            return f.render(*ins, params=p, t=0.3, width=w, height=h, device=dev)

        art_ms, live_ms = fenced_median_ms(art_render), fenced_median_ms(live_render)
        print(f"artifact {name} {w}x{h}: export {export_s:.2f} s, load {load_s:.2f} s, "
              f"{n_loops} while_loop at the top of the program; {len(settings)} param "
              f"settings {settings}, each render equal to the live render bit for bit with "
              f"the same launches, render_batch ({ARTIFACT_JOBS} jobs) and render_animation "
              f"({ARTIFACT_JOBS} frames) too; at {p}: render {art_ms:.3f} ms, "
              f"{host_syncs(art_render)} syncs, against the live render's {live_ms:.3f} ms, "
              f"{host_syncs(live_render)} syncs [{card}]")
    after = turbulence.render(**small)
    if isinstance(after, FakeTensor) or type(after) is not torch.Tensor or not after.is_cuda:
        raise AssertionError(f"C4: a live turbulence render after the exports is a "
                             f"{type(after).__name__} on {after.device}")
    if not torch.equal(after, before):
        raise AssertionError("C4: turbulence after the exports differs from before them")
    export_artifact(st["ridged_noise"], str(work / "ridged_again.mmxa"), w, h,
                    params={"octaves": 4, "scale": 120.0}, device=dev)
    print(f"C4: after the exports a live turbulence {small['width']}x{small['height']} render "
          f"is a torch.Tensor on {after.device} equal to the one before them bit for bit, "
          f"and ridged_noise exported a second time")


def phase_preview(mt, K, dev, card):
    """The preview app on 127.0.0.1 with cuda:0: /render (twirl), /animate
    (4 frames), /compose (grayscale -> twirl) and /render of a region over a
    1920x1080 u8 image, each reply's PNG equal to its lone card render
    packed to u8, bit for bit, each request launching B1; the median
    /render round trip."""
    import base64
    import urllib.request
    from http.server import ThreadingHTTPServer

    from mathmap_tpu_torch.imgio.images import to_uint8
    from mathmap_tpu_torch.imgio.png import decode_png
    from mathmap_tpu_torch.preview import PreviewState, _make_handler

    w, h = SIZES[0]
    _, u8 = smooth_image(w, h, seed=43)
    img = torch.from_numpy(u8).to(dev)
    state = PreviewState(u8, 256, mt.default_db(), device=dev)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    twirl = (ROOT / "filters" / "Distorts" / "twirl.mm").read_text()

    def post(path, req):
        before = launch_count(LAUNCH_B1)
        r = urllib.request.Request(base + path, json.dumps(req).encode(), method="POST")
        with urllib.request.urlopen(r, timeout=300) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise AssertionError(f"preview {path}: {out['error']}")
        if launch_count(LAUNCH_B1) == before:
            raise AssertionError(f"preview {path}: no B1 launch")
        return out

    def png(b64):
        return decode_png(base64.b64decode(b64))

    def same(tag, got, want):
        if not np.array_equal(got, want):
            n = int((got != want).any(-1).sum())
            raise AssertionError(f"preview {tag}: {n} pixels differ from the lone render")

    def lone(f, **kw):
        return to_uint8(f.render(img, device=dev, **kw).cpu().numpy())

    try:
        p = {"angle": 4.0}
        f = state._compile(twirl)
        same("/render", png(post("/render", {"source": twirl, "params": p})["png"]),
             lone(f, params=p))
        frames = post("/animate", {"source": twirl, "params": p, "frames": 4})["frames"]
        want = f.render_animation(img, num_frames=4, params=p, device=dev).cpu().numpy()
        for i, b64 in enumerate(frames):
            same(f"/animate frame {i}", png(b64), to_uint8(want[i]))
        out = post("/compose", PREVIEW_GRAPH)
        same("/compose", png(out["png"]), lone(state._compile(out["source"])))
        reg = (w // 5 + 3, h // 7 + 1, w // 2 - 9, h // 3 + 5)
        got = png(post("/render", {"source": twirl, "params": p, "region": list(reg)})["png"])
        x, y, rw, rh = reg
        mask = np.zeros((h, w, 1), bool)
        mask[y:y + rh, x:x + rw] = True
        same("/render region", got, np.where(mask, lone(f, params=p), u8))
        times = []
        for _ in range(PREVIEW_ROUND_TRIPS):
            t0 = time.perf_counter()
            post("/render", {"source": twirl, "params": p})
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"preview {w}x{h} on {dev}: /render, /animate (4 frames), /compose and a region "
          f"/render, each reply equal to its lone card render bit for bit and launching B1; "
          f"a /render round trip (PNG out) {statistics.median(times):.1f} ms, median of "
          f"{PREVIEW_ROUND_TRIPS} [{card}]")


def tile_hashes(tiles: dict) -> dict:
    """sha256 of each tile's bytes, keyed by its origin joined with '_'."""
    return {"_".join(map(str, o)): hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for o, t in tiles.items()}


def mesh_tiles(out, shape, lead: int = 0) -> dict:
    """The tiles (frame shards with `lead` frames a slice) of a one-process
    render over a mesh of `shape`, keyed as a LocalFrame keys them."""
    nf, ny, nx = shape
    th, tw = out.shape[-3] // ny, out.shape[-2] // nx
    tiles = {}
    for f, r, c in np.ndindex(*shape):
        if lead:
            tiles[f * lead, r * th, c * tw] = out[f * lead:(f + 1) * lead, r * th:(r + 1) * th,
                                                  c * tw:(c + 1) * tw]
        elif f == 0:
            tiles[r * th, c * tw] = out[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
    return tiles


def distributed_worker(rank: int, n: int, coord: str, out_dir: str, backend: str,
                       jobs: str) -> int:
    """One rank of phase_distributed's fleet (run as `chip_smoke.py
    --distributed-worker RANK N HOST:PORT DIR BACKEND JOBS`). JOBS "twirl":
    twirl at 1920x1080 over the global mesh of every rank's
    DISTRIBUTED_TILES rows, this rank's tiles saved to DIR; "tiled": pond
    4K through render_tiled over the global (1, 4, 1) mesh, its B4
    launches against its sampler calls and summed over the ranks, then 5
    fenced frames timed with the exchange's bytes and host time; "all":
    both, then the halo check, a render_sharded LocalFrame chained into
    render_tiled and the 4-frame mandelbrot sweep over (2, 2, 1). Each
    rank renders on cuda:0 (gloo), or its own card (NCCL, 2 ranks). One
    JSON line: the tiles' sha256 and every job's launches."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.kernels import apply_lut as L
    from mathmap_tpu_torch.kernels import sample_image as K
    from mathmap_tpu_torch.kernels import sample_tiled as B4
    from mathmap_tpu_torch.kernels import while_loop as WL
    from mathmap_tpu_torch.parallel import distributed, halo
    from mathmap_tpu_torch.runtime import sampling

    index = rank if backend == "nccl" and n > 1 else 0
    torch.cuda.set_device(index)
    dev = torch.device("cuda", index)
    distributed.initialize(coord, num_processes=n, process_id=rank, backend=backend)
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3, LAUNCH_B4, LAUNCH_B5)
    report = {"rank": rank, "backend": dist.get_backend(), "jobs": {}}

    def job(name, call):
        zero_launches(*wrappers)
        result = call()
        torch.cuda.synchronize()
        report["jobs"][name] = dict(result, launches=launch_counts(*wrappers))

    def summed(value: int) -> int:
        total = torch.tensor([value], device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(total)
        return int(total.item())

    def twirl():
        w, h = SIZES[0]
        mesh = distributed.global_mesh(rows=n * DISTRIBUTED_TILES,
                                       devices=[str(dev)] * DISTRIBUTED_TILES)
        img = torch.from_numpy(smooth_image(w, h, seed=45)[1]).to(dev)
        f = mt.compile_file(str(ROOT / "filters" / "Distorts" / "twirl.mm"))
        frame = f.render_sharded(img, mesh=mesh, params={"angle": 3.0})
        torch.cuda.synchronize()
        for (r0, _c0), tile in frame.tiles.items():
            np.save(Path(out_dir) / f"{backend}_rank{rank}_row{r0}.npy", tile.cpu().numpy())
        return {"rows": sorted(r0 for r0, _ in frame.tiles),
                "b1_all_ranks": summed(launch_count(LAUNCH_B1))}

    gw, gh = SIZES[1]
    u8 = seeded_image(gw, gh, seed=DISTRIBUTED_SEED)[1]
    pond = mt.compile_file(str(ROOT / "filters" / "Distorts" / "pond.mm"))

    def tiled():
        mesh = distributed.global_mesh(1, 4, 1, devices=[str(dev)] * (4 // n))
        with KernelCapture(sampling, "tiled_kernel") as cap:
            frame = pond.render_tiled(u8, mesh=mesh, t=0.3)
        return {"hashes": tile_hashes(frame.tiles), "sampler_calls": len(cap.calls),
                "b4_all_ranks": summed(launch_count(LAUNCH_B4))}

    def timing():
        """5 fenced tiled frames: the frame, the exchange and the reduction
        of the halo check (each fenced by a synchronize at its start, so
        it excludes the device work queued before it), the bytes sent;
        then the gloo staging alone: the sent pieces copied to the host
        and back, as the exchange copies them."""
        go = Path(out_dir) / TIMING_GO
        deadline = time.perf_counter() + 300
        while not go.exists():  # the card free of the other fleets
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{go} did not appear")
            time.sleep(0.05)
        mesh = distributed.global_mesh(1, 4, 1, devices=[str(dev)] * (4 // n))
        spent = {"exchange": [], "reduce": []}
        sent = []

        def timed(name, fn):
            def call(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                spent[name].append((time.perf_counter() - t0) * 1e3)
                if name == "exchange":
                    sent.extend(t for _, t in args[0])
                return out
            return call

        originals = halo.exchange, halo.all_reduce_max
        halo.exchange = timed("exchange", halo.exchange)
        halo.all_reduce_max = timed("reduce", halo.all_reduce_max)
        try:
            times = []
            for k in range(2 + DISTRIBUTED_TIMED):
                for v in spent.values():
                    v.clear()
                sent.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pond.render_tiled(u8, mesh=mesh, t=0.3)
                torch.cuda.synchronize()
                if k >= 2:
                    times.append(((time.perf_counter() - t0) * 1e3, sum(spent["exchange"]),
                                  sum(spent["reduce"])))
        finally:
            halo.exchange, halo.all_reduce_max = originals
        pieces = [t.clone() for t in sent]
        staging = []
        for _ in range(2 + DISTRIBUTED_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = [p.to("cpu").to(dev) for p in pieces]
            torch.cuda.synchronize()
            staging.append((time.perf_counter() - t0) * 1e3)
        del back
        return {"frame_ms": statistics.median(t for t, _, _ in times),
                "exchange_ms": statistics.median(e for _, e, _ in times),
                "reduce_ms": statistics.median(r for _, _, r in times),
                "staging_ms": statistics.median(staging[2:]),
                "bytes_sent": sum(p.numel() * p.element_size() for p in pieces)}

    def check():
        mesh = distributed.global_mesh(1, 4, 1, devices=[str(dev)] * (4 // n))
        try:
            mt.compile_source("origVal(xy + xy:[0, 40])").render_tiled(u8, halo=4, mesh=mesh)
        except mt.MMRuntimeError as e:
            return {"error": str(e)}
        raise AssertionError("a sample past the halo did not raise")

    def chain():
        mesh = distributed.global_mesh(1, 4, 1, devices=[str(dev)] * (4 // n))
        twirl_f = mt.compile_file(str(ROOT / "filters" / "Distorts" / "twirl.mm"))
        mid = twirl_f.render_sharded(u8, mesh=mesh, params={"angle": 3.0})
        frame = pond.render_tiled(mid, mesh=mesh, t=0.3)
        return {"hashes": tile_hashes(frame.tiles)}

    def sweep():
        mesh = distributed.global_mesh(2, 2, 1, devices=[str(dev)] * (4 // n))
        f = mt.compile_file(str(ROOT / "filters" / "Render" / "mandelbrot.mm"))
        frame = f.render_sharded(mesh=mesh, num_frames=SWEEP_FRAMES, width=gw, height=gh)
        shards = distributed.local_slice_of(frame)
        return {"hashes": tile_hashes(frame.tiles),
                "shapes": [list(s.shape) for s in shards]}

    if jobs in ("twirl", "all"):
        job("twirl", twirl)
    if jobs in ("tiled", "all"):
        job("tiled", tiled)
    if jobs == "all":
        job("check", check)
        job("chain", chain)
        job("sweep", sweep)
    if jobs in ("tiled", "all"):
        # timed after every count is read: its launches are not the path's
        report["timing"] = timing()
    print(json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def start_fleet(n: int, backend: str, jobs: str, work: Path) -> tuple:
    """Start an n-process fleet of distributed_worker on `backend` ->
    (its processes, its start time)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    t0 = time.perf_counter()
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              "--distributed-worker", str(r), str(n), coord, str(work),
                              backend, jobs], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=str(ROOT))
            for r in range(n)], t0


def wait_fleet(procs: list, t0: float, backend: str) -> tuple:
    """Wait for a fleet -> (each rank's report, wall seconds with process
    start-up); a rank that fails raises with its stderr."""
    outs = [p.communicate(timeout=300) for p in procs]
    wall = time.perf_counter() - t0
    reports = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed {backend} rank {r}: exit {p.returncode}: "
                                 f"{err[-3000:]}")
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports, wall


def phase_distributed(mt, B4, dev, work: Path, card: str) -> tuple:
    """A DISTRIBUTED_RANKS-process fleet over gloo, chosen explicitly (NCCL
    refuses two ranks on one card), whose ranks both render on cuda:0: the
    twirl rows of render_sharded (B1); pond 4K through render_tiled over
    the global (1, 4, 1) mesh, halo rows crossing ranks, B4 on each rank's
    two tiles; the halo check raising on both ranks; a render_sharded
    LocalFrame chained into render_tiled; default mandelbrot 4K as a
    4-frame sweep over (2, 2, 1), B2 and B3 on each rank. Every rank's
    tiles equal the one-process card render's over a mesh of the same
    shape bit for bit. Then the NCCL route at world size 1 and, with two
    cards, the tiled pond on NCCL. Returns the (B1, B2, B3, B4, B5) launches
    of every rank's counted jobs."""
    w, h = SIZES[0]
    img = torch.from_numpy(smooth_image(w, h, seed=45)[1]).to(dev)
    twirl = mt.compile_file(str(ROOT / "filters" / "Distorts" / "twirl.mm"))
    whole = twirl.render(img, params={"angle": 3.0}, device=dev).cpu().numpy()
    gw, gh = SIZES[1]
    u8 = seeded_image(gw, gh, seed=DISTRIBUTED_SEED)[1]
    pond = mt.compile_file(str(ROOT / "filters" / "Distorts" / "pond.mm"))
    mesh141 = card_mesh(mt, dev, (1, 4, 1))
    zero_launches(LAUNCH_B4)
    one = pond.render_tiled(u8, mesh=mesh141, t=0.3)
    torch.cuda.synchronize()
    one_b4 = launch_count(LAUNCH_B4)
    want = {"tiled": tile_hashes(mesh_tiles(one, (1, 4, 1)))}
    mid = twirl.render_sharded(u8, mesh=mesh141, params={"angle": 3.0})
    want["chain"] = tile_hashes(mesh_tiles(pond.render_tiled(mid, mesh=mesh141, t=0.3),
                                           (1, 4, 1)))
    mandel = mt.compile_file(str(ROOT / "filters" / "Render" / "mandelbrot.mm"))
    sweep = mandel.render_sharded(mesh=card_mesh(mt, dev, (2, 2, 1)), num_frames=SWEEP_FRAMES,
                                  width=gw, height=gh)
    want["sweep"] = tile_hashes(mesh_tiles(sweep, (2, 2, 1), lead=SWEEP_FRAMES // 2))
    one_ms = fenced_median_ms(lambda: pond.render_tiled(u8, mesh=mesh141, t=0.3),
                              DISTRIBUTED_TIMED)
    try:
        mt.compile_source("origVal(xy + xy:[0, 40])").render_tiled(u8, halo=4, mesh=mesh141)
    except mt.MMRuntimeError as e:
        want_error = str(e)
    else:
        raise AssertionError("a sample past the halo did not raise in one process")
    total = [0, 0, 0, 0, 0]
    # the gloo fleet and NCCL at world size 1 start together; the gloo
    # ranks time their frames once the other fleet has exited (TIMING_GO)
    go = work / TIMING_GO
    go.unlink(missing_ok=True)
    started = [start_fleet(DISTRIBUTED_RANKS, "gloo", "all", work),
               start_fleet(1, "nccl", "twirl", work)]
    try:
        nccl1 = wait_fleet(*started[1], "nccl")
        go.touch()
        runs = [("gloo", DISTRIBUTED_RANKS, wait_fleet(*started[0], "gloo")),
                ("nccl", 1, nccl1)]
        if torch.cuda.device_count() >= 2:
            started.append(start_fleet(2, "nccl", "tiled", work))
            runs.append(("nccl", 2, wait_fleet(*started[2], "nccl")))
    finally:
        for p in (p for procs, _ in started for p in procs):
            if p.poll() is None:
                p.kill()
                p.wait()
    if torch.cuda.device_count() < 2:
        print(f"distributed nccl, 2 processes: not run: this machine has "
              f"{torch.cuda.device_count()} CUDA device, and NCCL refuses two ranks on one "
              f"device; the NCCL halo exchange is unverified")
    for backend, n, (reports, wall) in runs:
        tag = f"distributed {backend}, {n} process(es)"
        for rep in reports:
            r = rep["rank"]
            for name, done in rep["jobs"].items():
                total = [a + b for a, b in zip(total, done["launches"])]
            if "twirl" in rep["jobs"]:
                done = rep["jobs"]["twirl"]
                tile_h = h // (n * DISTRIBUTED_TILES)
                if (done["launches"] != [DISTRIBUTED_TILES, 0, 0, 0, DISTRIBUTED_TILES]
                        or done["b1_all_ranks"] != n * DISTRIBUTED_TILES):
                    raise AssertionError(f"{tag} twirl: {done}")
                if done["rows"] != [(r * DISTRIBUTED_TILES + k) * tile_h
                                    for k in range(DISTRIBUTED_TILES)]:
                    raise AssertionError(f"{tag} twirl rank {r}: rows {done['rows']}")
                for r0 in done["rows"]:
                    tile = np.load(work / f"{backend}_rank{r}_row{r0}.npy")
                    if not np.array_equal(tile, whole[r0:r0 + tile_h]):
                        raise AssertionError(f"{tag} rank {r} rows {r0}..{r0 + tile_h}: "
                                             f"differ from the card render")
            for name in ("tiled", "chain", "sweep"):
                if name not in rep["jobs"]:
                    continue
                got = rep["jobs"][name]["hashes"]
                if not got or any(got[o] != want[name][o] for o in got):
                    raise AssertionError(f"{tag} {name} rank {r}: tiles {sorted(got)} differ "
                                         f"from the one-process card render's")
            if "tiled" in rep["jobs"]:
                done = rep["jobs"]["tiled"]
                if not (done["launches"][3] == done["sampler_calls"] == 4 // n
                        and done["b4_all_ranks"] == one_b4):
                    raise AssertionError(f"{tag} tiled rank {r}: B4 {done['launches'][3]}, "
                                         f"sampler calls {done['sampler_calls']}, all ranks "
                                         f"{done['b4_all_ranks']} (one process {one_b4})")
            if "check" in rep["jobs"] and rep["jobs"]["check"]["error"] != want_error:
                raise AssertionError(f"{tag} check rank {r}: {rep['jobs']['check']}")
            if "sweep" in rep["jobs"]:
                done = rep["jobs"]["sweep"]
                per = SWEEP_FRAMES // 2
                if (done["launches"][1:3] != [2 * per, 2 * per]
                        or done["shapes"] != [[per, gh // 2, gw, 4]] * 2):
                    raise AssertionError(f"{tag} sweep rank {r}: {done}")
        launches = [{k: v["launches"] for k, v in rep["jobs"].items()} for rep in reports]
        print(f"{tag} on {'cuda:0' if n == 1 or backend == 'gloo' else 'a card each'}: "
              f"{', '.join(reports[0]['jobs'])}: every rank's tiles equal to the "
              f"one-process card render's over a mesh of the same shape bit for bit; "
              f"(B1, B2, B3, B4, B5) launches by rank and job {launches}; "
              f"{wall:.1f} s wall with process start-up")
        if "check" in reports[0]["jobs"]:
            print(f"{tag}: a sample 40 rows away with halo 4 raises the same error on "
                  f"every rank: {want_error}")
        for rep in reports:
            if "timing" in rep:
                tm = rep["timing"]
                print(f"timing {tag} rank {rep['rank']}: pond {gw}x{gh} u8 in, render_tiled "
                      f"over the global (1,4,1) mesh ({4 // n} tiles a rank): median "
                      f"{tm['frame_ms']:.3f} ms/frame of {DISTRIBUTED_TIMED} fenced, of which "
                      f"the halo exchange {tm['exchange_ms']:.3f} ms (copies to and from "
                      f"the host, send/recv, the wait for the peer) and the halo check's "
                      f"all_reduce {tm['reduce_ms']:.3f} ms; {tm['bytes_sent']} bytes sent "
                      f"a frame, their staging through the host alone "
                      f"{tm['staging_ms']:.3f} ms; one process over (1,4,1) of cuda:0: "
                      f"{one_ms:.3f} ms/frame [{card}]")
    return tuple(total)


#: the reference's top-level names that the port once lacked
SURFACE_NAMES = ("read_image", "write_image", "to_float_rgba", "to_uint8", "Curve",
                 "Gradient", "InputImage", "__version__")
#: the reference's bound for a float32 render against its float64 spec
#: (tests/test_fuzz.py, test_random_expression_supersampled_and_f64)
SPEC_ATOL = 2e-4
#: tests/test_parity.py's rule for the escape-time filters: at most 2% of
#: the pixels beyond 5e-5 + 1e-4 * |spec|
CHAOTIC_ATOL, CHAOTIC_RTOL, CHAOTIC_SHARE = 5e-5, 1e-4, 0.02
#: a curve for the curve filter's LUT (64 rising samples)
SPEC_CURVE = np.cumsum(np.random.RandomState(8).rand(64)).astype(np.float32)
SPEC_CURVE /= SPEC_CURVE[-1]


def spec_cases(mt, filters, st, lib):
    """(label, filter, numpy inputs, render keywords, kernels the card
    render must launch, escape-time?, tiled mesh shape or None) of the
    float64 spec phase: the main path's sizes (1920x1080, u8 in) for the
    distortion suite, mandelbrot, the curve filter and tiled pond; 480x270
    for quat_julia, voronoi and turbulence (voronoi's card-vs-CPU watch
    size)."""
    (w, h), (rw, rh) = SIZES[0], REDUCED
    img = smooth_image(w, h, seed=41)[1]
    curve = mt.compile_file(str(ROOT / "filters" / "Colors" / "curve_adjust.mm"))
    bicubic = mt.RenderOptions(interpolation="bicubic")
    small = [smooth_image(rw, rh, seed=43)[1] for _ in lib["quat_julia"].image_params]
    return [
        ("fisheye", filters["fisheye"], [img], {}, ("B1",), False, None),
        ("twirl", filters["twirl"], [img], {}, ("B1",), False, None),
        ("pond", filters["pond"], [img], {}, ("B1",), False, None),
        ("twirl bicubic", filters["twirl"], [img], {"options": bicubic}, ("B1",), False,
         None),
        ("mandelbrot", filters["mandelbrot"], [], {"width": w, "height": h},
         ("B2", "B3"), True, None),
        ("curve_adjust", curve, [img], {"params": {"c": SPEC_CURVE}}, ("B1", "B2"), False,
         None),
        ("pond tiled (1,4,1)", filters["pond"], [img], {}, ("B4",), False, (1, 4, 1)),
        ("quat_julia", lib["quat_julia"], small, {"width": rw, "height": rh}, ("B3",),
         True, None),
        ("voronoi", st["voronoi"], [], {"width": rw, "height": rh}, ("B2",), False, None),
        ("turbulence", st["turbulence"], [], {"width": rw, "height": rh}, (), False, None),
    ]


def phase_float64_spec(mt, K, L, WL, B4, dev, filters, st, lib, card: str) -> dict:
    """The public surface and the reference's float64 spec on the card's
    machine. The eight names resolve; render(interpret=True) is a CPU
    tensor; interpret=True with device="cuda", and on_error="interpret",
    raise ValueError. Then each case of spec_cases renders on the card
    (Filter.render without a device: the card by default; render_tiled on
    a mesh of cuda:0), on the CPU's float32 route (interpret=True) and as
    the float64 spec (interpret=True, precision="f64"), and prints the
    card's and the CPU route's worst errors against the spec side by side.
    The card must stay within SPEC_ATOL of the spec (escape-time filters:
    tests/test_parity.py's 98% pixel rule), every output finite, and each
    card render must launch its kernels. Voronoi also prints, over the
    pixels where the card and the CPU differ, which of the two is nearer
    the spec. Returns {label: card's worst error}."""
    t0 = time.perf_counter()
    for name in SURFACE_NAMES:
        if getattr(mt, name) is None:
            raise AssertionError(f"mathmap_tpu_torch.{name} does not resolve")
    twirl = filters["twirl"]
    probe = smooth_image(64, 48, seed=40)[1]
    out = twirl.render(probe, interpret=True)
    if out.device.type != "cpu" or out.dtype != torch.float32:
        raise AssertionError(f"render(interpret=True): {out.device} {out.dtype}")
    for kw in ({"interpret": True, "device": "cuda"}, {"on_error": "interpret"}):
        try:
            twirl.render(probe, **kw)
        except ValueError:
            continue
        raise AssertionError(f"render(**{kw}) did not raise ValueError")
    print(f"float64 spec: {len(SURFACE_NAMES)} top-level names resolve; "
          f"render(interpret=True) -> cpu float32; interpret=True with device='cuda' "
          f"and on_error='interpret' raise ValueError")
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3, LAUNCH_B4)
    specs = {}
    worst = {}
    for label, f, inputs, kw, kernels, chaotic, mesh in spec_cases(mt, filters, st, lib):
        key = (id(f), tuple(id(a) for a in inputs), repr(kw))
        before = launch_counts(*wrappers)
        if mesh is None:
            got = f.render(*inputs, **kw)
        else:
            got = f.render_tiled(*(torch.from_numpy(a).to(dev) for a in inputs),
                                 mesh=card_mesh(mt, dev, mesh), **kw)
        torch.cuda.synchronize()
        launched = [n for n, b, a in zip(("B1", "B2", "B3", "B4"), before,
                                         launch_counts(*wrappers)) if a > b]
        if got.device.type != dev.type or not set(kernels) <= set(launched):
            raise AssertionError(f"float64 spec {label}: card render on {got.device} "
                                 f"launched {launched}, expected {kernels}")
        if key not in specs:
            ts = time.perf_counter()
            spec = f.render(*inputs, interpret=True, precision="f64", **kw)
            ts = time.perf_counter() - ts
            cpu = f.render(*inputs, interpret=True, **kw)
            if spec.dtype != torch.float64 or cpu.dtype != torch.float32:
                raise AssertionError(f"float64 spec {label}: {spec.dtype}, {cpu.dtype}")
            specs[key] = (spec.numpy(), cpu.double().numpy(), ts)
        spec, cpu, ts = specs[key]
        got = got.cpu().double().numpy()
        for name, a in (("card", got), ("cpu f32", cpu), ("spec", spec)):
            if not np.isfinite(a).all():
                raise AssertionError(f"float64 spec {label}: {name} output not finite")
        err_card, err_cpu = np.abs(got - spec), np.abs(cpu - spec)
        worst[label] = float(err_card.max())
        beyond = float((err_card > CHAOTIC_ATOL + CHAOTIC_RTOL * np.abs(spec))
                       .any(axis=-1).mean())
        rule = (f"{beyond:.4%} of pixels beyond {CHAOTIC_ATOL:g} + {CHAOTIC_RTOL:g}|spec| "
                f"(<= {CHAOTIC_SHARE:.0%})" if chaotic
                else f"<= {SPEC_ATOL:g}")
        h, w = spec.shape[:2]
        apart = (got != cpu).any(axis=-1)
        print(f"float64 spec {label} {w}x{h}: worst |card - spec| {worst[label]:.3e}, "
              f"|cpu f32 - spec| {float(err_cpu.max()):.3e} ({rule}); card and cpu f32 "
              f"differ at {int(apart.sum())} pixels (worst {float(np.abs(got - cpu).max()):.3e}); "
              f"launched {'+'.join(launched) or 'none'}; spec render {ts:.2f} s")
        if (beyond > CHAOTIC_SHARE) if chaotic else (worst[label] > SPEC_ATOL):
            raise AssertionError(f"float64 spec {label}: card beyond the spec ({rule})")
        if label == "voronoi":
            card_near = (err_card.max(-1) < err_cpu.max(-1)) & apart
            cpu_near = (err_cpu.max(-1) < err_card.max(-1)) & apart
            print(f"float64 spec voronoi watch: of the {int(apart.sum())} pixels where the "
                  f"card and the CPU f32 route differ, the card is nearer the spec at "
                  f"{int(card_near.sum())}, the CPU at {int(cpu_near.sum())}; their worst "
                  f"errors there: card {float(err_card[apart].max(initial=0.0)):.3e}, CPU "
                  f"{float(err_cpu[apart].max(initial=0.0)):.3e}")
    print(f"float64 spec phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return worst


#: values seeded into B5's planes: NaN, ±inf, signed zeros, the clamp's
#: ends and either side of them, the uint8 pack's rounding edges
FINISH_SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1.0, -1e-8,
                   1 + 1e-7, 0.5 / 255, 1.5 / 255, 127.5 / 255, 254.5 / 255, 3e38, -3e38)


def finish_planes(w: int, h: int, dev, layout: str = "contiguous", seed: int = 11) -> list:
    """Four (h, w) float32 planes on the card, values in [-0.5, 1.5) with
    FINISH_SPECIALS seeded in: "contiguous" as a sampler's or LUT's output
    unbinds them, or "moire" (a contiguous plane, a row broadcast, a column
    broadcast and a constant: stride 0 on one axis or both)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def values(*shape):
        v = torch.rand(shape, generator=g, device=dev) * 2.0 - 0.5
        flat = v.view(-1)
        n = min(flat.numel(), len(FINISH_SPECIALS))
        at = torch.randperm(flat.numel(), generator=g, device=dev)[:n]
        flat[at] = torch.tensor(FINISH_SPECIALS[:n], device=dev)
        return v

    if layout == "contiguous":
        return list(values(4, h, w).unbind(0))
    return [values(h, w), values(1, w).expand(h, w), values(h, 1).expand(h, w),
            values(1, 1).expand(h, w)]


def b5_instantiation(B5, out) -> str:
    """B5's instantiation for this output: one store a pixel or a channel."""
    wide = B5.wide_stores(out.data_ptr(), out.stride(0) * out.element_size(),
                          out.dtype == torch.uint8)
    return "wide" if wide else "narrow"


def finish_bytes(planes, out) -> int:
    """B5's bytes: each plane's distinct values read once (a broadcast
    plane's row, column or value), the frame written once."""
    read = 0
    for a in planes:
        n = 1
        for size, stride in zip(a.shape, a.stride()):
            n *= size if stride else 1
        read += n * 4
    return read + out.numel() * out.element_size()


#: phase 27's cases: (label, w, h, plane layout, output: a new frame, a
#: batch's slice or a view one element off alignment)
FINISH_CASES = (("4k", 3840, 2160, "contiguous", "new"),
                ("1080p", 1920, 1080, "contiguous", "new"),
                ("1080p batch slice", 1920, 1080, "contiguous", "batch"),
                ("moire 4k", 3840, 2160, "moire", "new"),
                ("ragged", 1919, 1081, "contiguous", "new"),
                ("unaligned out", 1920, 1080, "contiguous", "unaligned"))


def phase_finish_vs_plain(B5, dev) -> float:
    """Phase 27's check: B5 against its plain version bit for bit; each
    case prints its instantiation. Returns the worst difference (0.0)."""
    for label, w, h, layout, where in FINISH_CASES:
        planes = finish_planes(w, h, dev, layout)
        for u8 in (False, True):
            dtype = torch.uint8 if u8 else torch.float32
            for inv in (1.0, 1.0 / 9):
                if where == "batch":
                    out = torch.full((3, h, w, 4), 7, dtype=dtype, device=dev)[1]
                elif where == "unaligned":
                    out = torch.empty(h * w * 4 + 1, dtype=dtype, device=dev)[1:].view(h, w, 4)
                else:
                    out = torch.empty((h, w, 4), dtype=dtype, device=dev)
                before = launch_count(LAUNCH_B5)
                got = B5.finish_rgba(planes, inv, u8, None if where == "new" else out)
                want = B5.finish_rgba_reference(planes, inv, u8)
                torch.cuda.synchronize()
                if launch_count(LAUNCH_B5) != before + 1:
                    raise AssertionError(f"B5 {label}: not one launch")
                bits = (lambda t: t) if u8 else (lambda t: t.view(torch.int32))
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"B5 {label} {'u8' if u8 else 'f32'} inv {inv}: "
                                         f"{int((bits(got) != bits(want)).sum())} values "
                                         f"differ from the plain version")
            print(f"B5 vs plain {label} {w}x{h} {'u8' if u8 else 'f32'} out: bit for bit "
                  f"at inv 1 and 1/9, {b5_instantiation(B5, out)} stores")
    return 0.0


def time_b5(B5, dev, card) -> dict:
    """Phase 27's timings: B5 in turns with the eager chain it replaced
    (its plain ms) at each size, float32 and uint8 out, on contiguous
    planes and moire's layout, beside the bytes bound. Returns the 4K
    float32 contiguous record with the other 4K and 1080p times beside."""
    records = {}
    for (w, h) in SIZES:
        for layout in ("contiguous", "moire"):
            planes = finish_planes(w, h, dev, layout)
            for u8 in (False, True):
                out = torch.empty((h, w, 4), dtype=torch.uint8 if u8 else torch.float32,
                                  device=dev)
                kernel_ms, plain_ms = turns(
                    lambda: B5.finish_rgba_reference(planes, 1.0, u8, out),
                    lambda: B5.finish_rgba(planes, 1.0, u8, out), 20, 100)
                n_bytes = finish_bytes(planes, out)
                bound, by = bound_ms(n_bytes)
                tag = f"{'u8' if u8 else 'f32'}"
                print(f"timing B5 {w}x{h} {layout:10s} {tag:3s} out, "
                      f"{b5_instantiation(B5, out)} stores: kernel {kernel_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({n_bytes / 1e6:.1f} MB, {by}), "
                      f"{100 * bound / kernel_ms:.1f}% of bound, plain (the eager chain) "
                      f"{plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x) [{card}]")
                records[(w, h, layout, tag)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                                    bound_ms=bound, bound_by=by)
    w, h = SIZES[1]
    record = dict(records[(w, h, "contiguous", "f32")])
    record.update(u8_ms=records[(w, h, "contiguous", "u8")]["ms"],
                  moire_ms=records[(w, h, "moire", "f32")]["ms"],
                  ms_1080p=records[(SIZES[0][0], SIZES[0][1], "contiguous", "f32")]["ms"],
                  u8_ms_1080p=records[(SIZES[0][0], SIZES[0][1], "contiguous", "u8")]["ms"],
                  instantiation="finish_rgba_kernel<float32 out, wide stores>")
    return record


#: B6's single operations a point as csrc/perlin3.cu writes them: 3 floor,
#: 3 lattice indices (compare, convert, and, select: 4 each), 3 fractions,
#: 3 fades (7 each), 3 `- 1`, 6 hashes (15 loads and adds), 8 corner
#: lookups (12 loads and adds), 8 gradients (14 bit tests, selects and the
#: add each), 7 lerps (3 each)
B6_OPS_PER_POINT = 3 + 12 + 3 + 21 + 3 + 15 + 12 + 8 * 14 + 7 * 3


def perlin_cases(dev) -> dict:
    """Phase 28's inputs: label -> (x, y, z) on the card. The noise cell's
    calls take two contiguous 4K planes and a 0-d z: turbulence's octaves
    (x / scale * 2^k, y / scale * 2^k, t) and voronoi's cell coordinates
    (n1 at (cx k, cy k, 1/2), n2 at (cx k + 31.7, cy k + 17.3, 1/2) with
    cx = floor(x / cell) + i)."""
    w, h = SIZES[1]
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - w * 0.5
    ys = h * 0.5 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
    x, y = xs[None, :].expand(h, w).contiguous(), ys[:, None].expand(h, w).contiguous()

    def lit(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    scale, t, cell, k = lit(80.0), lit(0.37), lit(90.0), lit(0.7131)
    cx, cy = torch.floor(x / cell) - 1.0, torch.floor(y / cell) + 1.0
    rs = np.random.RandomState(28)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 3e9, -3e9, 2.0**31, 2.0**31 - 128,
                        1e20], np.float32)
    points = np.concatenate([
        rs.uniform(-300, 300, (3, 1 << 20)), rs.randint(-600, 600, (3, 4096)),
        rs.choice([-1, 1], (3, 4096)) * rs.uniform(2**24, 2**40, (3, 4096)),
        *(np.roll(np.stack([np.resize(special, 4096), rs.uniform(-9, 9, 4096),
                            rs.uniform(-9, 9, 4096)]), a, 0) for a in range(3)),
    ], axis=1).astype(np.float32)
    ragged = rs.uniform(-60, 60, (2, 1081, 1919)).astype(np.float32)
    batch = rs.uniform(-60, 60, (4, 1080, 1920)).astype(np.float32)
    return {
        "turbulence 4k": (x / scale, y / scale, t),
        "turbulence 4k octave 4": (x / scale * 8.0, y / scale * 8.0, t),
        "voronoi 4k n1": (cx * k, cy * k, lit(0.5)),
        "voronoi 4k n2": (cx * k + 31.7, cy * k + 17.3, lit(0.5)),
        "row and column 4k": (xs[None, :] / 7.0, ys[:, None] / 5.0, t),
        "batch (4, 1080, 1920)": (torch.from_numpy(batch).to(dev), y[:1080, :1920] / 9.0,
                                  lit([0.1, 0.4, 0.7, 0.9])[:, None, None]),
        "ragged 1919x1081": (*(torch.from_numpy(a).to(dev) for a in ragged), t),
        "points (random, lattice, large, NaN, inf)": tuple(
            torch.from_numpy(a).to(dev) for a in points),
    }


def phase_perlin_vs_plain(B6, build, dev) -> float:
    """Phase 28's check: B6 against its plain version bit for bit, one
    launch a call, and its ptxas report. Returns the worst difference
    (0.0)."""
    lines = [line for line in ptxas_report(build.library().log) if "perlin3" in line]
    for line in lines or ["none: the library was loaded from disk, not built in this run"]:
        print(f"B6 ptxas: {line}")
    for label, (x, y, z) in perlin_cases(dev).items():
        before = launch_count(LAUNCH_B6)
        got = B6.perlin3(x, y, z)
        want = B6.perlin3_reference(x, y, z)
        torch.cuda.synchronize()
        if launch_count(LAUNCH_B6) != before + 1:
            raise AssertionError(f"B6 {label}: not one launch")
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if got.shape != want.shape or differ:
            raise AssertionError(f"B6 {label}: {differ} values differ from the plain version")
        print(f"B6 vs plain {label} {tuple(got.shape)}: bit for bit, "
              f"{int(want.isnan().sum())} NaN, "
              f"{'wide' if B6.wide_stores(got.data_ptr(), got.shape[-1] * 4) else 'narrow'} "
              f"stores")
    return 0.0


def distinct_bytes(a) -> int:
    """A tensor's distinct float32 values (a broadcast axis counted once) at
    4 bytes each."""
    n = 1
    for size, stride in zip(a.shape, a.stride()):
        n *= size if stride else 1
    return 4 * n


def time_b6(B6, dev, card, rate: float) -> dict:
    """Phase 28's timings: B6 on the noise cell's two 4K layouts in turns
    with the eager chain it replaced (its plain ms), beside its bound.
    Returns turbulence's record with voronoi's ms beside it."""
    cases = perlin_cases(dev)
    records = {}
    for label in ("turbulence 4k", "voronoi 4k n2"):
        x, y, z = cases[label]
        out = B6.perlin3(x, y, z)
        kernel_ms, plain_ms = turns(lambda: B6.perlin3_reference(x, y, z),
                                    lambda: B6.perlin3(x, y, z), 5, 100)
        n_bytes = sum(distinct_bytes(a) for a in (x, y, z)) + 4 * out.numel()
        n_ops = B6_OPS_PER_POINT * out.numel()
        bound, by = bound_ms(n_bytes, n_ops, rate)
        print(f"timing B6 {label} {tuple(out.shape)}: kernel {kernel_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f}e9 single "
              f"ops), {100 * bound / kernel_ms:.1f}% of bound, plain (the eager chain) "
              f"{plain_ms:.4f} ms ({plain_ms / kernel_ms:.1f}x) [{card}]")
        records[label] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    record = dict(records["turbulence 4k"])
    record.update(voronoi_ms=records["voronoi 4k n2"]["ms"],
                  voronoi_plain_ms=records["voronoi 4k n2"]["plain_ms"],
                  instantiation="perlin3_kernel<wide stores>")
    return record


def main() -> int:
    if sys.argv[1:2] == ["--distributed-worker"]:
        rank, n, coord, out_dir, backend, jobs = sys.argv[2:8]
        return distributed_worker(int(rank), int(n), coord, out_dir, backend, jobs)
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
    from mathmap_tpu_torch.kernels import finish_rgba as B5
    from mathmap_tpu_torch.kernels import perlin3 as B6
    from mathmap_tpu_torch.kernels import sample_image as K
    from mathmap_tpu_torch.kernels import sample_tiled as B4
    from mathmap_tpu_torch.kernels import while_loop as WL
    from mathmap_tpu_torch.ops import color_ops
    from mathmap_tpu_torch.runtime import native_filters as NF
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
    lib = library_filters(mt)
    loop_filters += [(filters["mandelbrot"], ZOOMED), (sin_filter, {}), (rand_walk, {}),
                     (lib["quat_julia"], {}), (mt.compile(T_LOOP), {})]
    card = phase_card(mt, build, WL, tracer, loop_filters)
    rate, sms, mhz = single_op_rate()
    print(f"single-op issue rate: {sms} SMs x {LANES_PER_SM} lanes x {mhz:.0f} MHz "
          f"(clocks.max.sm) = {rate / 1e12:.2f}e12 op/s; INT32 half that")
    worst_b1 = phase_kernel_vs_plain(K, dev)
    worst_b2 = phase_lut_vs_plain(L, dev)
    worst_b3, worst_rand = phase_loop_vs_plain(mt, WL, tracer, dev, filters, sin_filter,
                                               rand_walk)
    worst_b4 = phase_tiled_vs_plain(B4, dev)
    worst_b5 = phase_finish_vs_plain(B5, dev)
    worst_b6 = phase_perlin_vs_plain(B6, build, dev)
    # each main path with every launch count set to 0 just before it and
    # read just after (B1, B2, B3, B4, B5, B6)
    wrappers = (LAUNCH_B1, LAUNCH_B2, LAUNCH_B3, LAUNCH_B4, LAUNCH_B5, LAUNCH_B6)
    by_path = {}

    def path(name, phase, *args):
        zero_launches(*wrappers)
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
    b3_qj_launches, worst_qj = path("library", phase_library_path, mt, K, L, WL, build, sampling,
                          color_ops, tracer, dev, lib)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        path("region", phase_region, mt, K, L, WL, B4, dev, filters, st)
        path("corners", phase_corners, mt, K, dev, filters)
        path("cli", phase_cli, mt, K, B4, dev, work)
        path("serve", phase_serve, mt, K, dev, card)
        path("selftest", phase_selftest, mt, dev)
        path("artifact", phase_artifact, mt, K, L, WL, build, dev, filters, work, card)
        path("preview", phase_preview, mt, K, dev, card)
        path("float64 spec", phase_float64_spec, mt, K, L, WL, B4, dev, filters, st, lib, card)
        path("artifact loops", phase_artifact_loops, mt, K, L, WL, dev, st, work, card)
        # the fleet's launches are its worker processes' own counts (B1-B5:
        # its renders call no noise)
        by_path["distributed"] = (*path("distributed", phase_distributed, mt, B4, dev, work,
                                        card), 0)
        names = ("sample_image", "apply_lut", "while_loop", "sample_tiled", "finish_rgba",
                 "perlin3")
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
        time_library(lib, dev, card)
        b3_qj = time_b3(WL, build, tracer, lambda: lib["quat_julia"].render(
            width=SIZES[1][0], height=SIZES[1][1], device=dev), f"quat_julia {SIZES[1][0]}x"
            f"{SIZES[1][1]}", card, rate, sass)
        time_gaussian_blur(NF, dev, card)
        time_region_corners(mt, dev, filters, st, card)
        time_cli_frame(mt, dev, work, card)
        b5 = time_b5(B5, dev, card)
        b6 = time_b6(B6, dev, card, rate)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    from mathmap_tpu_torch.utils.trace import snapshot

    built = snapshot()["spans"].get("mm.build", {})
    print(f"nvcc builds in this run: {nvcc_builds()}; kernel libraries built or loaded "
          f"(mm.build): {built.get('count', 0)}, {built.get('total_ns', 0) / 1e9:.2f} s in all")
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
        {"name": "while_loop (quat_julia)", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/while_loop.cu.tmpl",
         "replaces": "mathmap_tpu/pallas_kernels/while_kernel.py:143",
         "launches": b3_qj_launches, "max_abs_err": worst_qj, **b3_qj},
        {"name": "sample_tiled", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/sample_tiled.cu",
         "replaces": "mathmap_tpu/runtime/sampling.py:188",
         **counted("sample_tiled"), "max_abs_err": worst_b4, **b4},
        {"name": "finish_rgba", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/finish_rgba.cu",
         "replaces": "none (the eager finish of runtime/render.py::render_frame)",
         **counted("finish_rgba"), "max_abs_err": worst_b5, **b5},
        {"name": "perlin3", "route": "cuda",
         "source": "mathmap_tpu_torch/csrc/perlin3.cu",
         "replaces": "none (the eager Perlin chain of ops/noise.py's noise builtin)",
         **counted("perlin3"), "max_abs_err": worst_b6, **b6},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
