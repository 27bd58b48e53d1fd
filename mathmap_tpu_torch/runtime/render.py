"""Render engine (the port of the (H, W) path of
`mathmap_tpu/runtime/render.py`).

One render evaluates the filter over the whole (H, W) grid
(runtime.tracer): once without supersampling; once over the s×s grid
subsamples stacked on the row axis, whose row blocks it then sums (or in
a few walks of such stacks, where a frame holds more than WALK_POINTS
subsample points, or once per subsample where the filter draws rand() or
renders the float64 spec); twice under supersample_scheme='corners' (the
four corners and the centre of each pixel). It finishes the frame in
kernel B5 (kernels/finish_rgba.py): scaled by the samples' weight,
clipped to [0, 1] and optionally packed to uint8 on the device. A
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


#: the most points one walk of the body evaluates in a stacked walk of
#: subsamples (render_frame): a walk's temporaries grow with its points,
#: so this bounds their peak memory. On an H100 a ripple frame at 4K and
#: s = 3 (walks of 4, 4 and 1 subsamples, 33.2 M points the largest)
#: peaked 1.59 GB above its inputs, 0.47 GB walked once per subsample
WALK_POINTS = 2 ** 25


def _offset_axes(ctx: RenderContext, offsets):
    """The (w,) column and (h,) row world coordinates of ctx's grid at
    each subpixel offset (dx, dy) in `offsets` -> ([x], [y]), in the
    reference's order of operations (arange + (0.5 + dx) - W/2, and
    H/2 - (arange + (0.5 + dy))); offsets that share a dx (a dy) share
    its vector. The offsets are constants of the geometry
    (utils/constants.py)."""
    h, w = ctx.shape
    dt, dev = ctx.dtype, ctx.device
    half_w = constant(_LITERAL, ctx.width * 0.5, dt, dev)
    half_h = constant(_LITERAL, ctx.height * 0.5, dt, dev)
    cols = torch.arange(ctx.col_offset, ctx.col_offset + w, dtype=dt, device=dev)
    rows = torch.arange(ctx.row_offset, ctx.row_offset + h, dtype=dt, device=dev)
    xs = {dx: cols + constant(_LITERAL, 0.5 + dx, dt, dev) - half_w
          for dx in dict.fromkeys(dx for dx, _ in offsets)}
    ys = {dy: half_h - (rows + constant(_LITERAL, 0.5 + dy, dt, dev))
          for dy in dict.fromkeys(dy for _, dy in offsets)}
    return [xs[dx] for dx, _ in offsets], [ys[dy] for _, dy in offsets]


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
    (xs,), (ys,) = _offset_axes(ctx, [(dx, dy)])
    return torch.broadcast_to(xs[None, :], (h, w)), torch.broadcast_to(ys[:, None], (h, w))


def stacked_grids(ctx: RenderContext, offsets):
    """`coordinate_grids` of each subpixel offset in `offsets`, stacked on
    the row axis -> (x, y), each (k·h, w) for k offsets: row block i holds
    offset i's grids, the same floats. y is a broadcast view of one
    (k·h,) vector, x one concatenation."""
    h, w = ctx.shape
    xs, ys = _offset_axes(ctx, offsets)
    x = torch.cat([torch.broadcast_to(v[None, :], (h, w)) for v in xs])
    return x, torch.broadcast_to(torch.cat(ys)[:, None], x.shape)


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


def _eval_stacked(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
                  offsets) -> list:
    """One unclipped evaluation of the filter over the grids of the
    subpixel `offsets` stacked on the row axis (`stacked_grids`) -> each
    offset's 4 channel grids, in order: views of the walk's row blocks.
    W/H, the tile's offsets and world coordinates keep ctx's frame."""
    h, w = ctx.shape
    sub = replace(ctx, grid_shape=(len(offsets) * h, w), stacked=len(offsets))
    with _EVALUATE:
        x, y = stacked_grids(ctx, offsets)
        env = build_env(sub, fdef, uservals)
        ev = Evaluator(sub, x, y, env)
        comps = coerce_rgba(ev, ev.eval(fdef.body), fdef)
    ctx.rand_counter = sub.rand_counter
    ctx.rand_loop_nonce = sub.rand_loop_nonce
    return [[c[i * h:(i + 1) * h] for c in comps] for i in range(len(offsets))]


def uses_rand(filters: dict, fdef: A.FilterDef) -> bool:
    """Whether `fdef` (or any filter it calls) draws rand(): such filters
    keep one walk per subsample, since a draw is keyed on the pixel and
    the walk's counter."""
    seen = set()

    def walk_def(fd):
        if fd.name in seen:
            return False
        seen.add(fd.name)
        for sub in A.walk(fd.body):
            if isinstance(sub, A.Call) and isinstance(sub.func, A.Var):
                if sub.func.name == "rand":
                    return True
                called = filters.get(sub.func.name)
                if called is not None and walk_def(called):
                    return True
        return False

    return walk_def(fdef)


def subsamples_per_walk(ctx: RenderContext, fdef: A.FilterDef, s: int) -> int:
    """How many of a frame's s² grid subsamples one walk of the body
    evaluates: as many as fit WALK_POINTS, at least one; one where s is 1,
    in the float64 spec render, or where the filter draws rand()."""
    if s == 1 or ctx.dtype == torch.float64 or uses_rand(ctx.filters, fdef):
        return 1
    h, w = ctx.shape
    return max(1, min(s * s, WALK_POINTS // max(h * w, 1)))


def render_frame(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
                 out: torch.Tensor | None = None):
    """Render one frame, one tile of it or one region of it -> ctx.shape +
    (4,) in [0,1], float32 (float64 in the float64 spec render), or uint8
    when opts.output_dtype='uint8', written into `out` when given.

    The grid scheme walks its s² subsamples in order, as many a walk as
    `subsamples_per_walk` allows, and adds their planes in subsample
    order, so the frame is the same whatever the walks. Every frame
    finishes (scale by the samples' weight, clamp, interleave, pack) in
    one call of kernel B5's `finish_rgba`, on the CPU its plain version.
    Its output pixels add to `render.pixels`, the points its walks
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
        offsets = subpixel_offsets(s)
        per_walk = subsamples_per_walk(ctx, fdef, s)
        planes = None
        for k in range(0, len(offsets), per_walk):
            group = offsets[k:k + per_walk]
            count("render.walks")
            samples = ([_eval_rgba(ctx, fdef, uservals, *group[0])] if len(group) == 1
                       else _eval_stacked(ctx, fdef, uservals, group))
            for comps in samples:
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
