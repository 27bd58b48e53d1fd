"""Render engine (the port of the (H, W) path of
`mathmap_tpu/runtime/render.py`).

One render evaluates the filter once over the whole (H, W) grid per
subsample (runtime.tracer), averages the s×s grid subsamples, clips to
[0, 1] and optionally packs to uint8 on the device. PyTorch runs eagerly,
so there is nothing to compile or cache: `render` takes the whole
configuration on every call.
"""

from __future__ import annotations

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


def pack_uint8(rgba: torch.Tensor) -> torch.Tensor:
    """Device-side 8-bit packing, the reference's rule: clip to [0,1],
    ·255 + 0.5, floor. The explicit floor makes the float->int convert
    exact."""
    x = torch.clamp(rgba, 0.0, 1.0) * 255.0
    return torch.floor(x + 0.5).to(torch.uint8)


def render_frame(ctx: RenderContext, fdef: A.FilterDef, uservals: dict):
    """Render one frame, or one tile of it -> ctx.shape + (4,) float32 in
    [0,1] (uint8 when opts.output_dtype='uint8')."""
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
    # clamp to displayable range (the reference clamps when packing 8-bit)
    out = torch.clamp(rgba, 0.0, 1.0)
    if ctx.opts.output_dtype == "uint8":
        return pack_uint8(out)
    return out


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
           frame: float = 0.0) -> torch.Tensor:
    """Render one frame of `fdef` on `device`. `inputs`: (H, W, 4) float32
    or uint8 tensors on the device, one per image parameter in order."""
    validate_params(fdef, params, opts.static_params)
    ctx = RenderContext(
        device=device, width=width, height=height, opts=opts,
        filters=program_filters, t=float(t), frame=float(frame),
        inputs=[InputImage(pixels=a, name=f"in{i}")
                for i, a in enumerate(inputs)],
    )
    return render_frame(ctx, fdef, user_values(ctx, fdef, params))


def user_values(ctx: RenderContext, fdef: A.FilterDef, params: dict) -> dict:
    """The caller's param values as TupleValues on ctx's device."""
    return {p.name: convert_userval(ctx, p, params[p.name])
            for p in fdef.params if p.name in params}
