"""Render engine (the port of the (H, W) path of
`mathmap_tpu/runtime/render.py`).

One render evaluates the filter once over the whole (H, W) grid per
subsample (runtime.tracer), sums the s×s grid subsamples (or, under
supersample_scheme='corners', the four corners and the centre of each
pixel), and finishes the frame in kernel B5 (kernels/finish_rgba.py):
scaled by the samples' weight, clipped to [0, 1] and optionally packed to
uint8 on the device. A
region render evaluates only the region's (h, w) grid at its offset, with
the full canvas's coordinates, so it is the full render's crop bit for
bit. PyTorch runs eagerly,
so there is nothing to compile or cache: `render` takes the whole
configuration on every call, and a batch of jobs or an animation's frames
is one loop of such renders (`iter_jobs`).

`render(..., dtype=torch.float64)` on the CPU is the reference's float64
spec, `render_oracle(precision="f64")`: grids, literals, `t` and `frame`
in float64, inputs converted as the oracle converts them, and NumPy's
promotion (runtime/promotion.py) deciding what else becomes float64.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..kernels import finish_rgba as B5
from ..kernels.sample_image import u8_to_float
from ..lang import astnodes as A
from ..utils.constants import constant
from ..utils.errors import MMRuntimeError
from ..utils.trace import count, span
from .promotion import NumpyPromotion
from .tracer import Evaluator, RenderContext, coerce_rgba
from .uservals import convert_userval, default_userval
from .value import InputImage, image_value

_FRAME = span("mm.frame")
_EVALUATE = span("mm.evaluate")
_LITERAL = span("mm.sync.literal")


def coordinate_grids(ctx: RenderContext, dx: float = 0.0, dy: float = 0.0):
    """Centered world-coordinate grids: GLOBAL pixel (row j, col i) center
    at (i + 0.5 - W/2, H/2 - 0.5 - j), y pointing up. (dx, dy) are subpixel
    offsets in pixel units for supersampling. A tile of a mesh
    (ctx.grid_shape set) builds only its own rows and columns from its
    offsets, in the reference's order of operations (arange + offset +
    (0.5 + dx) - W/2), so its coordinates are the same floats as the
    whole frame's: the integer-valued aranges start at the offset, which
    equals adding it."""
    h, w = ctx.shape
    dt, dev = ctx.dtype, ctx.device
    # the four offsets are constants of the geometry (utils/constants.py)
    x_off = constant(_LITERAL, 0.5 + dx, dt, dev)
    half_w = constant(_LITERAL, ctx.width * 0.5, dt, dev)
    half_h = constant(_LITERAL, ctx.height * 0.5, dt, dev)
    y_off = constant(_LITERAL, 0.5 + dy, dt, dev)
    cols = torch.arange(ctx.col_offset, ctx.col_offset + w, dtype=dt, device=dev)
    rows = torch.arange(ctx.row_offset, ctx.row_offset + h, dtype=dt, device=dev)
    xs = cols + x_off - half_w
    ys = half_h - (rows + y_off)
    x = torch.broadcast_to(xs[None, :], (h, w))
    y = torch.broadcast_to(ys[:, None], (h, w))
    return x, y


def resolve_region(opts, width: int, height: int):
    """Validate opts.region against the canvas -> (x, y, w, h) or None.
    GIMP-selection semantics: only the sub-rectangle is evaluated, but
    x/y/W/H/R and input sampling use the FULL canvas."""
    reg = opts.region
    if reg is None:
        return None
    x, y, w, h = reg
    if x + w > width or y + h > height:
        raise ValueError(f"region {reg} exceeds the {width}x{height} canvas")
    return reg


def region_fields(region) -> dict:
    """RenderContext fields that evaluate only `region`'s grid: its shape
    at its global offset (the fields a mesh tile uses)."""
    if region is None:
        return {}
    x, y, w, h = region
    return dict(grid_shape=(h, w), row_offset=y, col_offset=x)


def output_shape(opts, width: int, height: int) -> tuple:
    """(rows, cols) of a frame's output: the region's, else the canvas's."""
    region = resolve_region(opts, width, height)
    return (height, width) if region is None else (region[3], region[2])


def float_inputs(arrays):
    """The tiled renderer's input blocks as float32: uint8 by
    kernels/sample_image.u8_to_float (the one conversion rule, the same
    values the sampler's u8 taps take), float32 as they are."""
    return [u8_to_float(a) if a.dtype == torch.uint8 else a for a in arrays]


def subpixel_offsets(s: int):
    """s×s subpixel offset grid within one pixel (s=1 -> center only)."""
    return [((i + 0.5) / s - 0.5, (j + 0.5) / s - 0.5) for j in range(s) for i in range(s)]


def build_env(ctx: RenderContext, fdef: A.FilterDef, uservals: dict):
    """Bind filter params: image params consume ctx.inputs positionally,
    others come from the `uservals` dict (already TupleValues) or defaults."""
    env = {}
    img_idx = 0
    for p in fdef.params:
        if p.kind == "image":
            if img_idx < len(ctx.inputs):
                env[p.name] = image_value(ctx.inputs[img_idx])
                img_idx += 1
            elif p.name in uservals:
                env[p.name] = uservals[p.name]
            else:
                raise MMRuntimeError(
                    f"filter {fdef.name!r}: no input bound for image parameter {p.name!r}",
                    p.span,
                )
        elif p.name in uservals:
            env[p.name] = uservals[p.name]
        else:
            env[p.name] = default_userval(ctx, p)
    return env


def _eval_rgba(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
               dx: float = 0.0, dy: float = 0.0) -> list:
    """One unclipped evaluation of the filter over ctx's grid at subpixel
    offset (dx, dy) -> its 4 channel grids."""
    with _EVALUATE:
        x, y = coordinate_grids(ctx, dx, dy)
        env = build_env(ctx, fdef, uservals)
        ev = Evaluator(ctx, x, y, env)
        return coerce_rgba(ev, ev.eval(fdef.body), fdef)


def _corners_sum(ctx: RenderContext, fdef: A.FilterDef, uservals: dict) -> torch.Tensor:
    """The corner-grid scheme's (H, W, 4) sum of a pixel's five samples,
    which weigh 1/5 each: ONE evaluation on the (h+1, w+1) grid of pixel
    corners (offset (-0.5, -0.5), each interior corner shared by four
    pixels), then the centres, added in the reference's order. W/H and
    world coordinates keep the real frame; only the evaluation grid grows.
    The rand counter and the loop nonce carry from the corner evaluation
    into the centre one, so the two draw distinct streams."""
    h, w = ctx.shape
    sub = replace(ctx, grid_shape=(h + 1, w + 1))
    corner = torch.stack(_eval_rgba(sub, fdef, uservals, -0.5, -0.5), dim=-1)
    ctx.rand_counter = sub.rand_counter
    ctx.rand_loop_nonce = sub.rand_loop_nonce
    center = torch.stack(_eval_rgba(ctx, fdef, uservals), dim=-1)
    return (corner[:-1, :-1] + corner[:-1, 1:] + corner[1:, :-1]
            + corner[1:, 1:] + center)


def render_frame(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
                 out: torch.Tensor | None = None):
    """Render one frame, one tile of it or one region of it -> ctx.shape +
    (4,) in [0,1], float32 (float64 in the float64 spec render), or uint8
    when opts.output_dtype='uint8', written into `out` when given.

    Every frame finishes (scale by the samples' weight, clamp, interleave,
    pack) in one call of kernel B5's `finish_rgba`, on the CPU its plain
    version. Its output pixels add to `render.pixels`, the points its walks
    evaluate to `render.samples` and its walks of the body to
    `render.walks`."""
    h, w = ctx.shape
    count("render.pixels", h * w)
    s = ctx.opts.supersample
    if s > 1 and ctx.opts.supersample_scheme == "corners":
        count("render.samples", (h + 1) * (w + 1) + h * w)
        count("render.walks", 2)
        total = _corners_sum(ctx, fdef, uservals)
        planes, inv = [total[..., c] for c in range(4)], 0.2
    else:
        count("render.samples", s * s * h * w)
        count("render.walks", s * s)
        planes = None
        for dx, dy in subpixel_offsets(s):
            comps = _eval_rgba(ctx, fdef, uservals, dx, dy)
            planes = list(comps) if planes is None else [a + c for a, c in zip(planes, comps)]
        inv = 1.0 / (s * s)
    return B5.finish_rgba(planes, inv, ctx.opts.output_dtype == "uint8", out)


def validate_params(fdef: A.FilterDef, params: dict, static_names) -> None:
    """Reject param names the filter doesn't declare (a typo would render
    with the default, silently wrong), and static_params that are not
    declared numeric params — the reference's rules."""
    declared = {p.name: p for p in fdef.params}
    unknown = [n for n in params if n not in declared]
    if unknown:
        raise ValueError(
            f"unknown param(s) for filter {fdef.name!r}: {unknown} "
            f"(declares: {sorted(declared)})")
    unknown = [n for n in static_names if n not in declared]
    if unknown:
        raise ValueError(
            f"static_params names not declared by filter "
            f"{fdef.name!r}: {unknown} (has: {sorted(declared)})")
    bad = [n for n in static_names
           if declared[n].kind in ("curve", "gradient", "image")]
    if bad:
        raise ValueError(
            f"static_params cannot bake opaque params {bad} "
            f"(curve/gradient/image values stay traced)")


def spec_input(a: torch.Tensor) -> torch.Tensor:
    """An input of the float64 spec render, converted as the reference's
    oracle converts it: uint8 to float32 /255 first, then float64."""
    return (u8_to_float(a) if a.dtype == torch.uint8 else a).to(torch.float64)


def render(program_filters: dict, fdef: A.FilterDef, width: int, height: int,
           opts, device: torch.device, inputs, params: dict, t: float = 0.0,
           frame: float = 0.0, out: torch.Tensor | None = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Render one frame of `fdef` on `device` -> (H, W, 4), or (h, w, 4)
    when opts.region is set. `inputs`: (H, W, 4) float32 or uint8 tensors
    on the device, or animated (T, H, W, 4) stacks of them, one per image
    parameter in order. `out`: a tensor of the output's shape and dtype to
    write the frame into. `dtype=torch.float64` (CPU only) renders the
    float64 spec: float64 output, or uint8 packed from it."""
    validate_params(fdef, params, opts.static_params)
    if dtype == torch.float64:
        if device.type != "cpu":
            raise ValueError(f"the float64 spec renders on the CPU, not {device}")
        inputs = [spec_input(a) for a in inputs]
    ctx = RenderContext(
        device=device, width=width, height=height, opts=opts,
        filters=program_filters, t=float(t), frame=float(frame), dtype=dtype,
        inputs=[InputImage(pixels=a, name=f"in{i}")
                for i, a in enumerate(inputs)],
        **region_fields(resolve_region(opts, width, height)),
    )
    if dtype != torch.float64:
        return render_frame(ctx, fdef, user_values(ctx, fdef, params), out)
    with NumpyPromotion():
        return render_frame(ctx, fdef, user_values(ctx, fdef, params), out)


def user_values(ctx: RenderContext, fdef: A.FilterDef, params: dict) -> dict:
    """The caller's param values as TupleValues on ctx's device."""
    return {p.name: convert_userval(ctx, p, params[p.name])
            for p in fdef.params if p.name in params}


def animation_ts(num_frames: int, periodic: bool) -> np.ndarray:
    """The t of each frame of an animation, float32 as the reference
    computes them: frame i of N at i/N when `periodic`, else i/(N-1)."""
    denom = num_frames if periodic else max(num_frames - 1, 1)
    return np.arange(num_frames, dtype=np.float32) / denom


def iter_jobs(program_filters: dict, fdef: A.FilterDef, width: int, height: int,
              opts, device: torch.device, inputs: list, shared_mask, params, ts, frames,
              out: torch.Tensor | None = None):
    """Yield N independent renders in order, each an (H, W, 4) tensor on
    `device`, (h, w, 4) with opts.region (uint8 with
    opts.output_dtype='uint8'). `inputs`: per input,
    one tensor on the device: a shared one (shared_mask True), which every
    job samples as it is, or an (N, H, W, 4) stack whose slice i job i
    samples. `params`: one dict for every job, or a list of N dicts. Job i
    renders at t = ts[i] with its `frame` internal frames[i], each job the
    same sequence of operations as its lone `render`, so equal to it bit
    for bit on one device. With `out`, an (N, ...) tensor of the outputs'
    shape, job i is written into out[i] and that view is yielded."""
    for i in range(len(ts)):
        ins = [a if shared else a[i] for a, shared in zip(inputs, shared_mask)]
        job_params = params[i] if isinstance(params, (list, tuple)) else params
        with _FRAME:
            frame = render(program_filters, fdef, width, height, opts, device, ins,
                           job_params, t=float(ts[i]), frame=float(frames[i]),
                           out=None if out is None else out[i])
        yield frame


def render_jobs(program_filters: dict, fdef: A.FilterDef, width: int, height: int,
                opts, device: torch.device, inputs: list, shared_mask, params,
                ts, frames) -> torch.Tensor:
    """`iter_jobs` run into one preallocated output -> (N, H, W, 4) on
    `device`, (N, h, w, 4) with opts.region: each job's last operation
    writes its slice."""
    dtype = torch.uint8 if opts.output_dtype == "uint8" else torch.float32
    out = torch.empty((len(ts), *output_shape(opts, width, height), 4), dtype=dtype,
                      device=device)
    for _ in iter_jobs(program_filters, fdef, width, height, opts, device, inputs,
                       shared_mask, params, ts, frames, out):
        pass
    return out
