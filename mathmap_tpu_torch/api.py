"""Public Python API: compile MathMap source -> Filter; render with PyTorch
on the device the caller names (the port of `mathmap_tpu/api.py`).

The same `.mm` sources compile to a `Filter` whose `render()` evaluates the
filter over the whole pixel grid on `device` ("cuda" by default): eager
elementwise torch ops, with origVal going through the hand-written CUDA
sampler on the GPU (kernels/sample_image.py). Nothing falls back to the CPU:
asking for "cuda" on a machine without a GPU raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import inputs_from_numpy
from .lang import astnodes as A
from .lang.parser import parse
from .ops.registry import not_ported
from .runtime.options import RenderOptions
from .runtime.render import render
from .utils.errors import MMError, MMNameError


def resolve_device(device) -> torch.device:
    """The caller's device; "cuda" without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is available "
            f"(pass device='cpu' for the plain PyTorch path)")
    return dev


def _stage_input(a, device: torch.device) -> torch.Tensor:
    """numpy or torch image -> (H, W, 4) float32/uint8 tensor on `device`."""
    if isinstance(a, torch.Tensor):
        if a.dim() != 3 or a.shape[-1] != 4 or a.dtype not in (torch.float32, torch.uint8):
            raise ValueError(
                f"tensor inputs must be (H, W, 4) float32 or uint8, got "
                f"{tuple(a.shape)} {a.dtype}")
        return a.to(device).contiguous()
    if np.ndim(a) != 2 and np.ndim(a) != 3:
        raise NotImplementedError(
            "animated (T, H, W, 4) inputs are not ported yet (ROADMAP A4)")
    return inputs_from_numpy([a], device)[0]


class Filter:
    """A compiled MathMap filter (plus the filter environment of its file)."""

    def __init__(self, program: A.Program, fdef: A.FilterDef):
        self.fdef = fdef
        self.filters = {f.name: f for f in program.filters}

    def render(self, *inputs, width: int | None = None, height: int | None = None,
               t: float = 0.0, frame: float = 0.0,
               options: RenderOptions | None = None, params: dict | None = None,
               device="cuda") -> torch.Tensor:
        """Render one frame -> (H, W, 4) tensor on `device`: float32 in
        [0, 1], or uint8 with options.output_dtype='uint8'.

        inputs: (H, W, C) numpy arrays or (H, W, 4) float32/uint8 tensors,
        bound to the filter's image parameters in order. The output size
        defaults to the first input's (512x512 without inputs)."""
        dev = resolve_device(device)
        ins = [_stage_input(a, dev) for a in inputs]
        if width is None:
            width = ins[0].shape[1] if ins else 512
        if height is None:
            height = ins[0].shape[0] if ins else 512
        return render(self.filters, self.fdef, int(width), int(height),
                      options or RenderOptions(), dev, ins, params or {},
                      t=t, frame=frame)

    def render_batch(self, *args, **kwargs):
        raise not_ported("Filter.render_batch", "ROADMAP A4")

    def render_animation(self, *args, **kwargs):
        raise not_ported("Filter.render_animation", "ROADMAP A4")

    def render_sharded(self, *args, **kwargs):
        raise not_ported("Filter.render_sharded", "ROADMAP A9")

    def render_tiled(self, *args, **kwargs):
        raise not_ported("Filter.render_tiled", "ROADMAP A9")


def compile_source(source: str, main: str | None = None) -> Filter:
    """Compile MathMap source. `main` selects a filter by name; default is
    the last filter in the file."""
    try:
        program = parse(source)
    except MMError as exc:
        if exc.source is None:
            exc.source = source
        raise
    if not program.filters:
        raise MMNameError("source contains no filters")
    if main is None:
        fdef = program.filters[-1]
    else:
        by_name = {f.name: f for f in program.filters}
        if main not in by_name:
            raise MMNameError(f"no filter named {main!r} in source")
        fdef = by_name[main]
    return Filter(program, fdef)


def compile_file(path: str, main: str | None = None) -> Filter:
    with open(path) as f:
        return compile_source(f.read(), main=main)
