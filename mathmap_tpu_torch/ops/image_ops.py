"""Image-sampling builtins: origVal and origValXY (the port of
`mathmap_tpu/ops/image_ops.py`). `origVal(xy)` samples the first input at
world coordinates; `origValXY(x, y[, frame])` is the two-scalar form, whose
frame index selects the frame of an ANIMATED (T, H, W, 4) input (animation
in -> animation out; indices round and clamp; a single-frame input clamps
every index to its one frame). Without it, an animated input is sampled at
the render's current frame."""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..utils.errors import MMRuntimeError, MMTypeError
from .registry import builtin, need_args, need_length, need_tag


def _first_input(ev, span):
    if not ev.ctx.inputs:
        raise MMRuntimeError("origVal: no input image bound to this invocation", span)
    return ev.ctx.inputs[0]


@builtin("origVal")
def _orig_val(ev, args, span):
    (p,) = need_args(args, 1, "origVal", span)
    need_length(p, 2, "origVal", span)
    img = _first_input(ev, span)
    x, y = ev.grid(p.arrays[0]), ev.grid(p.arrays[1])
    return TupleValue("rgba", tuple(img.sample(ev, x, y)))


@builtin("origValXY")
def _orig_val_xy(ev, args, span):
    if len(args) not in (2, 3):
        raise MMTypeError(f"'origValXY' expects 2 or 3 arguments, got {len(args)}", span)
    x = ev.grid(args[0].scalar(span))
    y = ev.grid(args[1].scalar(span))
    img = _first_input(ev, span)
    frame = None
    if len(args) == 3:
        # a literal frame stays a Python float: selecting its frame then
        # needs no device sync; a scalar expression is a 0-d tensor and a
        # per-pixel one a grid (runtime/sampling.py)
        frame = args[2].scalar(span)
        if args[2].const is not None:
            frame = float(args[2].const[0])
    return TupleValue("rgba", tuple(img.sample(ev, x, y, frame=frame)))


@builtin("origValImage")
def _orig_val_image(ev, args, span):
    """origValImage(image, xy) — sample an explicit image value."""
    img_v, p = need_args(args, 2, "origValImage", span)
    need_tag(img_v, "image", "origValImage", span)
    need_length(p, 2, "origValImage", span)
    x, y = ev.grid(p.arrays[0]), ev.grid(p.arrays[1])
    return TupleValue("rgba", tuple(img_v.payload.sample(ev, x, y)))
