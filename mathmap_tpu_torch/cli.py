"""Command-line renderer (the port of `mathmap_tpu/cli.py`, flag for flag).

Usage:
    python -m mathmap_tpu_torch 'expr or file.mm' [in.png ...] out.png \
        --size 512x512 --frames 1 --interpolation bilinear \
        --edge-x color --edge-y color --supersample \
        --param name=value --interpret --profile DIR --verbose

It renders on the GPU (the current CUDA device), or on the CPU when
MMTPU_PLATFORM=cpu is set or --interpret is given (the kernels' plain
versions); without a GPU and without either it raises. --tiled and
--sharded take a mesh of every visible GPU, or of the CPU. PNG, PAM and
PPM files are read and written without Pillow; JPEG and GIF need it.

Exported artifacts (generators/artifact.py):
    python -m mathmap_tpu_torch twirl --export-artifact tw.mmxa \
        --size 512x512 --param angle=3
    python -m mathmap_tpu_torch tw.mmxa in.png out.png --param angle=5
An artifact is exported on the device the CLI renders on and runs there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np

from .api import _resolve_size, compile_file, compile_source, platform_device, shared
from .convert import inputs_from_numpy
from .imgio.images import (image_size, read_animation, read_image, to_uint8, write_animation,
                           write_image)
from .runtime.options import EDGE_BEHAVIORS, INTERPOLATIONS, RenderOptions
from .utils.errors import MMError

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mathmap_tpu_torch",
        description="MathMap renderer on PyTorch and CUDA (CLI front end)",
    )
    p.add_argument("expression", nargs="?", default=None,
                   help="MathMap expression, path to a .mm/.mmc file, or a library filter name")
    p.add_argument("--list", action="store_true",
                   help="list the bundled filter library (expression database) and exit")
    p.add_argument("--selftest", action="store_true",
                   help="run the deployment acceptance sweep on the active "
                        "device (each path class vs the CPU route, the "
                        "kernels' plain versions; seconds) and exit 0/1")
    p.add_argument("--library", default=None, metavar="DIR",
                   help="scan DIR as the filter library instead of the bundled one")
    p.add_argument("--chain", default=None, metavar="SPEC",
                   help='compose library filters: "grayscale | twirl angle=4" '
                        "(used instead of the expression argument)")
    p.add_argument("--save-chain", default=None, metavar="FILE.mmc",
                   help="with --chain: also save the graph as a composer file")
    p.add_argument("images", nargs="*", help="input image(s)..., then the output image")
    p.add_argument("--size", default=None, help="output WxH (default: first input's size, else 512x512)")
    p.add_argument("--frames", type=int, default=1, help="number of animation frames")
    p.add_argument("--non-periodic", action="store_true", help="t = frame/(N-1) instead of frame/N")
    p.add_argument("--interpolation", choices=INTERPOLATIONS, default="bilinear")
    p.add_argument("--edge-x", choices=EDGE_BEHAVIORS, default="color")
    p.add_argument("--edge-y", choices=EDGE_BEHAVIORS, default="color")
    p.add_argument("--edge-color", default="0,0,0,0", help="RGBA floats for 'color' edge behavior")
    p.add_argument("--supersample", nargs="?", type=int, const=2, default=1,
                   metavar="N", help="NxN supersampling AA (default 2 when given bare)")
    p.add_argument("--supersample-scheme", choices=("grid", "corners"),
                   default="grid",
                   help="AA sample placement: s×s subpixel grid, or the "
                        "shared corner grid + pixel centers (5 samples/px "
                        "at ~2.07x one render)")
    p.add_argument("--output-dtype", choices=("float32", "uint8"),
                   default="float32",
                   help="uint8 packs the 8-bit output ON THE DEVICE (bit-"
                        "identical to the host pack) — 4x less "
                        "device->host transfer per frame")
    p.add_argument("--filter", dest="filter_name", default=None, help="filter name when the file defines several")
    p.add_argument("--param", action="append", default=[], metavar="NAME=VALUE", help="set a userval")
    p.add_argument("--static-params", default="", metavar="NAME[,NAME...]",
                   help="treat these uservals as constants of the render "
                   "(a constant int loop bound statically unrolls its loop)")
    p.add_argument("--seed", type=int, default=0, help="rand() seed")
    p.add_argument("--sampler", choices=("auto", "pallas", "gather"), default="auto",
                   help="accepted for the reference's scripts; no effect "
                        "(origVal always takes the CUDA sampler on the GPU)")
    p.add_argument("--precision", choices=("bf16", "f32"), default="bf16",
                   help="accepted for the reference's scripts; no effect "
                        "(the sampler computes in fp32)")
    p.add_argument("--pallas-per-tile", choices=("auto", "on", "off"),
                   default="auto",
                   help="accepted for the reference's scripts; no effect")
    p.add_argument("--pallas-while", choices=("auto", "on", "off"), default="auto",
                   help="while-loop kernel switch: auto (eligible loops on "
                        "the GPU kernel after the static unroll), on (over "
                        "the unroll), off (the masked eager loop)")
    p.add_argument("--region", default=None, metavar="X,Y,WxH",
                   help="render only the (X, Y, WxH) sub-rectangle of the "
                        "canvas (GIMP-selection semantics: x/y/W/H/R and "
                        "input sampling keep the FULL canvas; the output "
                        "image is WxH). With --tiled the output is the "
                        "FULL canvas — the selection rendered in place, "
                        "unselected pixels passed through from the input "
                        "(the sharded-drawable semantics)")
    p.add_argument("--t", type=float, default=0.0, help="animation time for single-frame renders")
    p.add_argument("--interpret", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    p.add_argument("--fallback", action="store_true",
                   help="refused: no device failure is hidden behind a CPU render")
    p.add_argument("--resume", action="store_true", help="skip animation frames whose output file exists")
    p.add_argument("--batch", action="store_true",
                   help="render all animation frames through render_animation "
                        "(inputs staged once, one preallocated output)")
    p.add_argument("--fps", type=float, default=25.0, help="GIF animation frame rate")
    p.add_argument("--sharded", action="store_true",
                   help="shard the render across all visible GPUs (mesh over grid rows)")
    p.add_argument("--tiled", action="store_true",
                   help="shard the INPUT across GPUs with halo exchange "
                        "(parallel/halo.py) — for inputs too large to "
                        "replicate; requires a bounded source displacement")
    p.add_argument("--halo", default="auto",
                   help="tiled-mode halo: rows, rows,cols, or 'auto' "
                        "(infer the displacement bound from the filter)")
    p.add_argument("--input-dir", default=None, metavar="DIR",
                   help="batch mode: apply the filter to every image in DIR "
                        "(same-geometry images render --batch-size at a "
                        "time via render_batch); the output argument is a "
                        "directory")
    p.add_argument("--batch-size", type=int, default=16,
                   help="images per render_batch call in --input-dir mode")
    p.add_argument("--export-artifact", default=None, metavar="FILE.mmxa",
                   help="trace the filter at --size on the render device and "
                        "write it as an artifact (--param names become its "
                        "runtime inputs; --frames N also lets it render the "
                        "N-frame sweep). Render one with: mathmap_tpu_torch "
                        "FILE.mmxa [in ...] out")
    p.add_argument("--artifact-batch-sizes", default="", metavar="N[,N...]",
                   help="with --export-artifact: the batch sizes its "
                        "render_batch takes (up to the largest)")
    p.add_argument("--param-sweep", default=None, metavar="NAME=LO:HI",
                   help="animate a numeric param over --frames steps "
                        "(t stays --t; the `frame` internal is the step "
                        "index) in ONE render_batch call over the input "
                        "passed SHARED. Output: GIF or a frame sequence, "
                        "like --frames")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR/trace.json")
    p.add_argument("--stats", action="store_true", help="print one JSON line of render statistics")
    p.add_argument("--verbose", "-v", action="store_true", help="print per-phase timing and render stats")
    return p


def _parse_params(items):
    params = {}
    for item in items:
        if "=" not in item:
            raise SystemExit(f"--param expects NAME=VALUE, got {item!r}")
        name, value = item.split("=", 1)
        try:
            params[name] = json.loads(value)
        except json.JSONDecodeError:
            params[name] = value
    return params


def _parse_halo(spec):
    if spec == "auto":
        return "auto"
    parts = [s.strip() for s in str(spec).split(",")]
    try:
        vals = [int(s) for s in parts]
    except ValueError:
        raise SystemExit(f"--halo expects an int, 'rows,cols', or 'auto'; "
                         f"got {spec!r}")
    return vals[0] if len(vals) == 1 else (vals[0], vals[1])


def _parse_region(spec):
    """X,Y,WxH -> (x, y, w, h), or a one-line SystemExit."""
    try:
        parts = spec.split(",")
        if len(parts) != 3 or "x" not in parts[2].lower():
            raise ValueError
        rx, ry = int(parts[0]), int(parts[1])
        rw, rh = (int(v) for v in parts[2].lower().split("x"))
        # range-checked here: int('-1') parses, and a RenderOptions
        # ValueError would be a traceback instead of a one-line error
        if rx < 0 or ry < 0 or rw < 1 or rh < 1:
            raise ValueError
        return rx, ry, rw, rh
    except ValueError:
        raise SystemExit(
            f"--region wants X,Y,WxH (X,Y >= 0; W,H >= 1; "
            f"e.g. 100,50,640x480); got {spec!r}")


def _parse_size(spec):
    """WxH, or N for NxN -> (width, height), or a one-line SystemExit."""
    try:
        dims = [int(v) for v in spec.lower().split("x")]
        if len(dims) == 1:
            dims = dims * 2
        width, height = dims
        if width < 1 or height < 1:
            raise ValueError
        return width, height
    except ValueError:
        raise SystemExit(f"--size wants WxH (or one N for NxN); got {spec!r}")


def _sweep_ts(args):
    denom = args.frames if not args.non_periodic else max(args.frames - 1, 1)
    return np.arange(args.frames, dtype=np.float32) / denom


def _parse_param_sweep(spec, filt, n):
    """NAME=LO:HI -> (name, [n values LO..HI]). int params round each
    step half-up; non-numeric params are rejected (a sweep needs an
    axis)."""
    name, _, rng = spec.partition("=")
    lo_s, _, hi_s = rng.partition(":")
    if not (name and lo_s and hi_s):
        raise SystemExit(f"--param-sweep expects NAME=LO:HI, got {spec!r}")
    try:
        lo, hi = float(lo_s), float(hi_s)
    except ValueError:
        raise SystemExit(f"--param-sweep expects numeric LO:HI, got {spec!r}")
    kinds = {p.name: p.kind for p in filt.params}
    if name not in kinds:
        raise SystemExit(f"--param-sweep: filter has no param {name!r} "
                         f"(has: {', '.join(sorted(kinds)) or 'none'})")
    if kinds[name] not in ("float", "int"):
        raise SystemExit(f"--param-sweep: param {name!r} is "
                         f"{kinds[name]!r}; only float/int params sweep")
    if n < 2:
        raise SystemExit("--param-sweep needs --frames >= 2 (the number "
                         "of sweep steps)")
    vals = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    if kinds[name] == "int":
        # half-UP, not round()'s half-to-even: banker's rounding makes a
        # linear slider sweep cluster at .5 midpoints (0,2,2,4,4...)
        vals = [int(math.floor(v + 0.5)) for v in vals]
    return name, vals


def _frame_path(path: str, frame: int, num_frames: int) -> str:
    if num_frames == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_{frame:04d}{ext or '.png'}"


def _mesh(device):
    """--tiled/--sharded's mesh: every visible GPU, or the CPU."""
    from .parallel.mesh import make_mesh

    return make_mesh() if device.type == "cuda" else make_mesh(devices=["cpu"])


class _Run:
    """One CLI invocation's render state: the filter, its inputs staged on
    the device once, the output size, options and params."""

    def __init__(self, args, filt, inputs, width, height, opts, params, device):
        self.args, self.filt = args, filt
        self.width, self.height = width, height
        self.opts, self.params, self.device = opts, params, device
        self.mesh = _mesh(device) if (args.tiled or args.sharded) else None
        target = self.mesh.devices[0, 0, 0] if self.mesh is not None else device
        # the API stages numpy on each call and takes tensors on the device
        # as they are, so every frame reuses this one upload
        self.inputs = inputs_from_numpy(inputs, target)

    def frame(self, t: float, i: int):
        """One frame at t with its `frame` internal i -> (h, w, 4) tensor."""
        a, kw = self.args, dict(width=self.width, height=self.height, options=self.opts,
                                params=self.params, t=float(t), frame=float(i))
        if a.tiled:
            return self.filt.render_tiled(*self.inputs, halo=_parse_halo(a.halo),
                                          mesh=self.mesh, **kw)
        if a.sharded:
            return self.filt.render_sharded(*self.inputs, mesh=self.mesh, **kw)
        return self.filt.render(*self.inputs, device=self.device, **kw)

    def sweep(self):
        """Every animation frame in one call (--batch, GIF output) -> a
        sequence of (h, w, 4) tensors: render_animation, render_sharded's
        frame sweep, or the tiled frames one by one."""
        a = self.args
        if a.tiled:
            return [self.frame(t, i) for i, t in enumerate(_sweep_ts(a))]
        kw = dict(num_frames=a.frames, width=self.width, height=self.height,
                  options=self.opts, params=self.params)
        if a.sharded:
            return self.filt.render_sharded(*self.inputs, mesh=self.mesh, **kw)
        return self.filt.render_animation(*self.inputs, device=self.device, **kw)

    def param_sweep(self):
        """--param-sweep: N jobs over ONE shared input in one render_batch
        call -> (N, h, w, 4)."""
        a = self.args
        name, vals = _parse_param_sweep(a.param_sweep, self.filt, a.frames)
        if a.sharded or a.tiled or a.input_dir is not None or a.batch:
            raise SystemExit("--param-sweep runs the one-call batch path; "
                             "it does not combine with --sharded/--tiled/"
                             "--input-dir/--batch")
        n = a.frames
        return self.filt.render_batch(
            *[shared(x) for x in self.inputs], ts=np.full(n, a.t, np.float32),
            frames=np.arange(n, dtype=np.float32), width=self.width,
            height=self.height, options=self.opts,
            params=[{**self.params, name: v} for v in vals], device=self.device)


def _run_batch_dir(args, run, out_dir, log):
    """--input-dir mode: render every image in a directory through
    render_batch (same-geometry images grouped, `--batch-size` a call).
    Returns the number of frames written."""
    exts = (".png", ".jpg", ".jpeg", ".ppm", ".pam", ".pnm", ".bmp", ".tif",
            ".tiff", ".webp")
    names = sorted(n for n in os.listdir(args.input_dir)
                   if n.lower().endswith(exts))
    if not names:
        raise SystemExit(f"--input-dir: no images found in {args.input_dir}")
    os.makedirs(out_dir, exist_ok=True)
    # group by geometry from the headers alone: a big folder is not decoded
    # into memory at once
    groups: dict = {}
    for n in names:
        w, h = image_size(os.path.join(args.input_dir, n))
        groups.setdefault((h, w), []).append(n)
    filt, done = run.filt, 0
    for (h, w), group in groups.items():
        ow, oh = run.width or w, run.height or h
        log(f"batch group {w}x{h}: {len(group)} image(s) -> {ow}x{oh}")

        def out_path(n):
            # outputs are RGBA: always PNG (a .jpg name would drop alpha)
            return os.path.join(out_dir, os.path.splitext(n)[0] + ".png")

        if args.resume:
            # skip before rendering: a resumed job renders only what is missing
            group = [n for n in group if not os.path.exists(out_path(n))]
        step = max(1, args.batch_size)
        for start in range(0, len(group), step):
            chunk = group[start:start + step]
            stack = np.stack([read_image(os.path.join(args.input_dir, n)) for n in chunk])
            # frame 0 for every image, like a lone render (the default
            # arange is for t-sweeps)
            outs = filt.render_batch(stack, ts=[args.t] * len(chunk),
                                     frames=np.zeros(len(chunk), np.float32),
                                     width=ow, height=oh, options=run.opts,
                                     params=run.params, device=run.device)
            for n, frame in zip(chunk, outs):
                write_image(out_path(n), frame)
                done += 1
    return done


@contextlib.contextmanager
def _profiler(trace_dir):
    """--profile DIR: a torch.profiler Chrome trace of the render,
    DIR/trace.json (CPU activity, and CUDA's where a GPU is visible)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _run_artifact(args, input_paths, out_path, device, log) -> int:
    """Render from an exported .mmxa (no parser, evaluator or compile): one
    frame by default; --frames matching the exported animation renders the
    sweep (GIF out or a frame sequence)."""
    from .generators.artifact import load_artifact

    t0 = time.perf_counter()
    try:
        art = load_artifact(args.expression, platform=device.type)
    except (ValueError, OSError) as exc:
        print(exc, file=sys.stderr)
        return 1
    m = art.manifest
    log(f"loaded {args.expression}: filter {m['filter']!r} "
        f"{m['width']}x{m['height']}, params {sorted(m['params'])}, "
        f"load {time.perf_counter() - t0:.3f}s")
    inputs = [read_image(p) for p in input_paths]
    params = _parse_params(args.param)
    try:
        t1 = time.perf_counter()
        if args.frames > 1:
            if m.get("anim_frames") != args.frames:
                raise SystemExit(
                    f"artifact has {'no' if not m.get('anim_frames') else m['anim_frames']}-frame "
                    f"animation program; re-export with --frames "
                    f"{args.frames} (got --frames {args.frames})")
            frames = art.render_animation(*inputs, params=params)
            if out_path.lower().endswith(".gif"):
                write_animation(out_path, np.stack([to_uint8(f) for f in frames]), fps=args.fps)
            else:
                for i, fr in enumerate(frames):
                    write_image(_frame_path(out_path, i, len(frames)), fr)
            n = len(frames)
        else:
            write_image(out_path, art.render(*inputs, params=params, t=args.t))
            n = 1
        dt = time.perf_counter() - t1
        log(f"render: {dt:.3f}s  {n} frame(s)  "
            f"{n * m['width'] * m['height'] / max(dt, 1e-9) / 1e6:.2f} Mpix/s")
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


def _device(args):
    """--interpret: the CPU; else the front ends' device (a one-line exit
    for a bad MMTPU_PLATFORM or a missing GPU)."""
    import torch

    if args.interpret:
        return torch.device("cpu")
    try:
        return platform_device()
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(str(exc))


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.fallback:
        raise SystemExit("--fallback is not supported: no device failure is "
                         "hidden behind a CPU render (use --interpret to "
                         "render on the CPU)")
    if args.tiled and args.sharded:
        raise SystemExit("--tiled (input-sharded) and --sharded "
                         "(output-sharded) are mutually exclusive")
    region = None
    if args.region is not None:
        if args.sharded:
            raise SystemExit(
                "--region cannot be combined with --sharded (an output-"
                "sharded region IS a tile); use --tiled for the sharded-"
                "drawable selection semantics, or render unsharded")
        region = _parse_region(args.region)
    verbose = args.verbose

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr)

    def get_db():
        from .expression_db import ExpressionDB, default_db

        return ExpressionDB.scan(args.library) if args.library else default_db()

    if args.selftest:
        from .selftest import run_selftest

        size = 128
        if args.size:
            # the sweep is square-only: refuse a non-square request
            # instead of silently dropping the height
            dims = [int(v) for v in args.size.lower().split("x")]
            if len(dims) == 1:
                dims = dims * 2
            if len(dims) != 2 or dims[0] != dims[1]:
                raise SystemExit("--selftest runs square renders; use --size NxN")
            size = dims[0]
        return 1 if run_selftest(size=size, verbose=verbose, device=_device(args)) else 0

    if args.list:
        db = get_db()
        print(db.tree())
        for path, err in db.errors:
            print(f"# skipped {path}: {err}", file=sys.stderr)
        return 0

    if args.expression is None and args.chain is None:
        raise SystemExit("missing expression (or use --list / --chain)")
    if args.chain is not None and args.expression is not None:
        args.images.insert(0, args.expression)  # expression slot was an image
    if not args.images and not args.export_artifact:
        raise SystemExit("missing output image path")
    if args.export_artifact:
        input_paths, out_path = args.images, None
    else:
        *input_paths, out_path = args.images

    if args.expression and args.expression.endswith(".mmxa"):
        if args.export_artifact:
            raise SystemExit(
                "cannot --export-artifact from a .mmxa (artifacts carry "
                "no filter source); export from the .mm source instead")
        return _run_artifact(args, input_paths, out_path, _device(args), log)

    t0 = time.perf_counter()
    try:
        if args.chain is not None:
            from .designer.graph import from_pipeline

            graph = from_pipeline(args.chain, db=get_db())
            if args.save_chain:
                graph.save(args.save_chain)
            filt = graph.compile()
        elif args.expression.endswith(".mmc"):
            from .designer.graph import load_mmc

            filt = load_mmc(args.expression, db=get_db()).compile()
        elif args.expression.endswith(".mm") or os.path.exists(args.expression):
            filt = compile_file(args.expression, main=args.filter_name)
        else:
            db = get_db()
            if args.expression in db.entries:
                filt = db.compile(args.expression)  # library filter by name
            else:
                filt = compile_source(args.expression, main=args.filter_name)
    except MMError as exc:
        print(exc.format(), file=sys.stderr)
        return 1
    log(f"parse: {time.perf_counter() - t0:.3f}s  (filter {filt.name!r})")

    def read_input(p):
        if p.lower().endswith(".gif"):
            # multi-frame GIFs become ANIMATED (T, H, W, 4) inputs;
            # single-frame GIFs stay plain images (Pillow decodes them)
            stack = read_animation(p)
            return stack if stack.shape[0] > 1 else stack[0]
        return read_image(p)

    t_read = time.perf_counter()
    inputs = [read_input(p) for p in input_paths]
    log(f"decode: {time.perf_counter() - t_read:.3f}s  ({len(inputs)} input(s))")
    width = height = None
    if args.size:
        width, height = _parse_size(args.size)
    try:
        edge_color = tuple(float(c) for c in args.edge_color.split(","))
    except ValueError:
        raise SystemExit(
            f"--edge-color wants comma-separated floats (R,G,B[,A]); "
            f"got {args.edge_color!r}")
    try:
        opts = RenderOptions(
            interpolation=args.interpolation,
            edge_x=args.edge_x,
            edge_y=args.edge_y,
            edge_color=edge_color,
            supersample=args.supersample,
            supersample_scheme=args.supersample_scheme,
            output_dtype=args.output_dtype,
            periodic=not args.non_periodic,
            seed=args.seed,
            sampler=args.sampler,
            pallas_precision=args.precision,
            pallas_per_tile=args.pallas_per_tile,
            pallas_while=args.pallas_while,
            static_params=tuple(n.strip() for n in args.static_params.split(",")
                                if n.strip()),
            region=region,
        )
    except ValueError as exc:
        raise SystemExit(str(exc))
    params = _parse_params(args.param)

    # the canvas, by the API's own defaulting
    cw, ch = _resolve_size(inputs, width, height)
    if region is not None:
        # the one-line bounds error
        if region[0] + region[2] > cw or region[1] + region[3] > ch:
            print(f"--region {args.region} exceeds the {cw}x{ch} canvas",
                  file=sys.stderr)
            return 1

    device = _device(args)
    if args.export_artifact:
        from .generators.artifact import export_artifact

        bs = tuple(int(x) for x in args.artifact_batch_sizes.split(",") if x.strip())
        try:
            export_artifact(filt, args.export_artifact, cw, ch, options=opts, params=params,
                            batch_sizes=bs,
                            anim_frames=args.frames if args.frames > 1 else None,
                            device=device)
        except MMError as exc:
            print(exc.format(), file=sys.stderr)
            return 1
        log(f"exported {args.export_artifact}: {cw}x{ch} on {device}, "
            f"params {sorted(params)}, batch_sizes {list(bs)}, "
            f"anim_frames {args.frames if args.frames > 1 else None}")
        return 0
    try:
        with _profiler(args.profile):
            t1 = time.perf_counter()
            run = _Run(args, filt, inputs, width, height, opts, params, device)
            if args.param_sweep is not None:
                # dispatched FIRST so its flag-combination guard fires even
                # with --input-dir
                frames = run.param_sweep()
                if out_path.lower().endswith(".gif"):
                    write_animation(out_path, frames, fps=args.fps)
                else:
                    for i in range(args.frames):
                        write_image(_frame_path(out_path, i, args.frames), frames[i])
                frames_done = args.frames
            elif args.input_dir is not None:
                frames_done = _run_batch_dir(args, run, out_path, log)
            elif args.frames <= 1:
                write_image(out_path, run.frame(args.t, 0))
                frames_done = 1
            elif out_path.lower().endswith(".gif"):
                # each frame packed on the host as it comes off the device
                write_animation(out_path, np.stack([to_uint8(f) for f in run.sweep()]),
                                fps=args.fps)
                frames_done = args.frames
            elif args.batch:
                frames = run.sweep()
                frames_done = 0
                for i in range(args.frames):
                    path = _frame_path(out_path, i, args.frames)
                    if args.resume and os.path.exists(path):
                        continue
                    write_image(path, frames[i])
                    frames_done += 1
            else:
                # frame by frame, resuming before each render
                frames_done = 0
                for i, t in enumerate(_sweep_ts(args)):
                    path = _frame_path(out_path, i, args.frames)
                    if args.resume and os.path.exists(path):
                        continue
                    write_image(path, run.frame(t, i))
                    frames_done += 1
            dt = time.perf_counter() - t1
    except MMError as exc:
        print(exc.format(), file=sys.stderr)
        return 1
    log(f"render: {dt:.3f}s  {frames_done} frame(s)  "
        f"{frames_done * ch * cw / 1e6 / max(dt, 1e-9):.2f} Mpix/s")
    if args.stats:
        from .utils.log import RenderStats

        print(RenderStats(width=cw, height=ch, frames=frames_done, parse_s=t1 - t0,
                          render_s=dt).to_json())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
