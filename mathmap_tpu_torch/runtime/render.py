"""Render engine (the port of the (H, W) path of
`mathmap_tpu/runtime/render.py`).

One render evaluates the filter once over the whole (H, W) grid per
subsample (runtime.tracer), averages the s×s grid subsamples, clips to
[0, 1] and optionally packs to uint8 on the device. PyTorch runs eagerly,
so there is nothing to compile or cache: `render` takes the whole
configuration on every call, and a batch of jobs or an animation's frames
is one loop of such renders (`iter_jobs`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sample_image import u8_to_float
from ..lang import astnodes as A
from ..utils.errors import MMRuntimeError
from .tracer import Evaluator, RenderContext, coerce_rgba
from .uservals import convert_userval, default_userval
from .value import InputImage, image_value


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

    def lit(v):
        return torch.tensor(v, dtype=dt, device=dev)

    cols = torch.arange(ctx.col_offset, ctx.col_offset + w, dtype=dt, device=dev)
    rows = torch.arange(ctx.row_offset, ctx.row_offset + h, dtype=dt, device=dev)
    xs = cols + lit(0.5 + dx) - lit(ctx.width * 0.5)
    ys = lit(ctx.height * 0.5) - (rows + lit(0.5 + dy))
    x = torch.broadcast_to(xs[None, :], (h, w))
    y = torch.broadcast_to(ys[:, None], (h, w))
    return x, y


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


def pack_uint8(rgba: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Device-side 8-bit packing, the reference's rule: clip to [0,1],
    ·255 + 0.5, floor. The explicit floor makes the float->int convert
    exact. `out`: a uint8 tensor to cast into."""
    x = torch.floor(torch.clamp(rgba, 0.0, 1.0) * 255.0 + 0.5)
    return x.to(torch.uint8) if out is None else out.copy_(x)


def render_frame(ctx: RenderContext, fdef: A.FilterDef, uservals: dict,
                 out: torch.Tensor | None = None):
    """Render one frame, or one tile of it -> ctx.shape + (4,) float32 in
    [0,1] (uint8 when opts.output_dtype='uint8'), written into `out` when
    given."""
    s = ctx.opts.supersample
    acc = None
    for dx, dy in subpixel_offsets(s):
        x, y = coordinate_grids(ctx, dx, dy)
        env = build_env(ctx, fdef, uservals)
        ev = Evaluator(ctx, x, y, env)
        comps = coerce_rgba(ev, ev.eval(fdef.body), fdef)
        acc = list(comps) if acc is None else [a + c for a, c in zip(acc, comps)]
    inv = 1.0 / (s * s)
    rgba = torch.stack([a * inv for a in acc], dim=-1)
    if ctx.opts.output_dtype == "uint8":
        return pack_uint8(rgba, out)
    # clamp to displayable range (the reference clamps when packing 8-bit)
    return torch.clamp(rgba, 0.0, 1.0, out=out)


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


def render(program_filters: dict, fdef: A.FilterDef, width: int, height: int,
           opts, device: torch.device, inputs, params: dict, t: float = 0.0,
           frame: float = 0.0, out: torch.Tensor | None = None) -> torch.Tensor:
    """Render one frame of `fdef` on `device`. `inputs`: (H, W, 4) float32
    or uint8 tensors on the device, or animated (T, H, W, 4) stacks of
    them, one per image parameter in order. `out`: an (H, W, 4) tensor of
    the output dtype to write the frame into."""
    validate_params(fdef, params, opts.static_params)
    ctx = RenderContext(
        device=device, width=width, height=height, opts=opts,
        filters=program_filters, t=float(t), frame=float(frame),
        inputs=[InputImage(pixels=a, name=f"in{i}")
                for i, a in enumerate(inputs)],
    )
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
    `device` (uint8 with opts.output_dtype='uint8'). `inputs`: per input,
    one tensor on the device: a shared one (shared_mask True), which every
    job samples as it is, or an (N, H, W, 4) stack whose slice i job i
    samples. `params`: one dict for every job, or a list of N dicts. Job i
    renders at t = ts[i] with its `frame` internal frames[i], each job the
    same sequence of operations as its lone `render`, so equal to it bit
    for bit on one device. With `out`, an (N, H, W, 4) tensor, job i is
    written into out[i] and that view is yielded."""
    for i in range(len(ts)):
        ins = [a if shared else a[i] for a, shared in zip(inputs, shared_mask)]
        job_params = params[i] if isinstance(params, (list, tuple)) else params
        yield render(program_filters, fdef, width, height, opts, device, ins, job_params,
                     t=float(ts[i]), frame=float(frames[i]),
                     out=None if out is None else out[i])


def render_jobs(program_filters: dict, fdef: A.FilterDef, width: int, height: int,
                opts, device: torch.device, inputs: list, shared_mask, params,
                ts, frames) -> torch.Tensor:
    """`iter_jobs` run into one preallocated output -> (N, H, W, 4) on
    `device`: each job's last operation writes its slice."""
    dtype = torch.uint8 if opts.output_dtype == "uint8" else torch.float32
    out = torch.empty((len(ts), height, width, 4), dtype=dtype, device=device)
    for _ in iter_jobs(program_filters, fdef, width, height, opts, device, inputs,
                       shared_mask, params, ts, frames, out):
        pass
    return out
