"""Public Python API: compile MathMap source -> Filter; render with PyTorch
on the device the caller names (the port of `mathmap_tpu/api.py`).

The same `.mm` sources compile to a `Filter` whose `render()` evaluates the
filter over the whole pixel grid on `device` ("cuda" by default): eager
elementwise torch ops, with origVal going through the hand-written CUDA
sampler on the GPU (kernels/sample_image.py). `render_sharded()` and
`render_tiled()` split the grid over a mesh of devices (parallel/). Nothing
falls back to the CPU: asking for "cuda", or for the default mesh, on a
machine without a GPU raises.
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


def _resolve_size(inputs, width, height):
    """The output size: the caller's, else the first input's (512x512
    without inputs)."""
    if width is None:
        width = inputs[0].shape[1] if inputs else 512
    if height is None:
        height = inputs[0].shape[0] if inputs else 512
    return int(width), int(height)


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
        width, height = _resolve_size(ins, width, height)
        return render(self.filters, self.fdef, width, height,
                      options or RenderOptions(), dev, ins, params or {},
                      t=t, frame=frame)

    def render_batch(self, *args, **kwargs):
        raise not_ported("Filter.render_batch", "ROADMAP A4")

    def render_animation(self, *args, **kwargs):
        raise not_ported("Filter.render_animation", "ROADMAP A4")

    def render_sharded(self, *inputs, mesh=None, num_frames: int = 1,
                       width: int | None = None, height: int | None = None,
                       options: RenderOptions | None = None, t: float = 0.0,
                       frame: float = 0.0, params: dict | None = None) -> torch.Tensor:
        """Render one frame with the grid split over a mesh's rows/cols
        (parallel/shard.py): every tile renders its own grid, with each
        input copied to its device -> (H, W, 4) tensor on the mesh's first
        device. `mesh=None` puts every visible GPU on the row axis (and
        raises without one; a CPU mesh is make_mesh(devices=["cpu"] * n)).
        A frame batch (num_frames > 1) is not ported (ROADMAP A4)."""
        from .parallel.mesh import make_mesh, tile_devices
        from .parallel.shard import render_frame_sharded

        if num_frames != 1:
            raise not_ported("render_sharded of a frame batch (num_frames > 1)",
                             "ROADMAP A4")
        if mesh is None:
            mesh = make_mesh()
        first = tile_devices(mesh)[0, 0]
        ins = [_stage_input(a, first) for a in inputs]
        width, height = _resolve_size(ins, width, height)
        return render_frame_sharded(mesh, self.filters, self.fdef, width, height,
                                    options or RenderOptions(), ins, params or {},
                                    t=t, frame=frame)

    def render_tiled(self, *input_images, halo: int | tuple | str = "auto",
                     mesh=None, width: int | None = None,
                     height: int | None = None,
                     options: RenderOptions | None = None, t: float = 0.0,
                     frame: float = 0.0, params: dict | None = None,
                     check: bool = True) -> torch.Tensor:
        """Render with the INPUT(s) split over a mesh's rows (and, on a 2-D
        mesh, columns) and halo rows/cols exchanged between neighbouring
        tiles (parallel/halo.py), for inputs too large to replicate ->
        (H, W, 4) tensor on the mesh's first device. Every input must have
        the output's geometry. The filter's displacement must be bounded by
        `halo`: "auto" infers the bound from the filter's AST
        (parallel/bounds.py), and check=True turns a violated bound into an
        MMRuntimeError instead of a silent clamp. `mesh=None` puts every
        visible GPU on the row axis."""
        from .parallel.halo import TiledRenderer
        from .parallel.mesh import make_mesh, tile_devices

        if mesh is None:
            mesh = make_mesh()
        first = tile_devices(mesh)[0, 0]
        imgs = [_stage_input(a, first) for a in input_images]
        width, height = _resolve_size(imgs, width, height)
        for a in imgs:
            if tuple(a.shape[:2]) != (height, width):
                raise ValueError(
                    f"tiled inputs must share the output geometry "
                    f"{height}x{width}; got {a.shape[0]}x{a.shape[1]}")
        renderer = TiledRenderer(mesh, self.filters, self.fdef, width, height,
                                 options or RenderOptions(), halo, params=params,
                                 check=check)
        return renderer(imgs, t=t, frame=frame)


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
