"""Public Python API: compile MathMap source -> Filter; render with PyTorch
on the device the caller names (the port of `mathmap_tpu/api.py`).

The same `.mm` sources compile to a `Filter` whose `render()` evaluates the
filter over the whole pixel grid on `device` ("cuda" by default): eager
elementwise torch ops, with origVal going through the hand-written CUDA
sampler on the GPU (kernels/sample_image.py). `render(interpret=True)` is
the CPU route, the kernels' plain versions, and with `precision="f64"` the
reference's float64 spec. `render_batch()` renders N
independent jobs, `render_animation()` and `render_frames()` a t-sweep;
`render_sharded()` and `render_tiled()` split the grid (and a sweep's
frames) over a mesh of devices (parallel/); `RenderOptions.region` renders a
selection. Nothing falls back to the CPU:
asking for "cuda", or for the default mesh, on a machine without a GPU
raises, and so does the reference's `on_error="interpret"`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .convert import inputs_from_numpy
from .lang import astnodes as A
from .lang.parser import parse
from .runtime.options import RenderOptions
from .runtime.render import animation_ts, iter_jobs, render, render_jobs
from .utils.errors import MMError, MMNameError


def resolve_device(device) -> torch.device:
    """The caller's device; "cuda" without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is available "
            f"(pass device='cpu' for the plain PyTorch path)")
    return dev


def platform_device() -> torch.device:
    """The front ends' device (CLI, --selftest, the service): the current
    CUDA device, or the CPU when MMTPU_PLATFORM=cpu, the reference's own
    switch. Any other value raises, and so does a machine without a GPU
    when the variable is unset: nothing renders on the CPU unasked."""
    plat = os.environ.get("MMTPU_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat:
        raise ValueError(f"MMTPU_PLATFORM must be 'cpu' or unset, got {plat!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available (set MMTPU_PLATFORM=cpu to "
                           "render on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def _stage_input(a, device: torch.device) -> torch.Tensor:
    """numpy or torch image -> (H, W, 4) float32/uint8 tensor on `device`;
    a 4-D one is an ANIMATED input -> (T, H, W, 4). uint8 stays uint8 on
    the device (the sampler converts each tap)."""
    if isinstance(a, torch.Tensor):
        if a.dim() not in (3, 4) or a.shape[-1] != 4 or a.dtype not in (torch.float32,
                                                                         torch.uint8):
            raise ValueError(
                f"tensor inputs must be (H, W, 4) or animated (T, H, W, 4) float32 or "
                f"uint8, got {tuple(a.shape)} {a.dtype}")
        return a.to(device).contiguous()
    return inputs_from_numpy([a], device)[0]


def _stage_batch(batch, device: torch.device) -> torch.Tensor:
    """A render_batch input -> an (N, H, W, 4) stack on `device`: an (N, H,
    W, C) array or tensor, or a list of N (H, W, C) frames. A lone (H, W,
    C) frame raises: it would otherwise be taken for H jobs of its rows."""
    if isinstance(batch, (list, tuple)):
        if all(isinstance(f, torch.Tensor) for f in batch):
            return torch.stack([_stage_input(f, device) for f in batch])
        batch = np.stack([np.asarray(f) for f in batch])
    shape = tuple(batch.shape) if isinstance(batch, torch.Tensor) else np.shape(batch)
    if len(shape) == 3 and shape[-1] in (1, 3, 4):
        raise ValueError(
            "render_batch inputs need a leading batch axis; wrap a "
            "single frame in a list (or use render())")
    return _stage_input(batch, device)


def _resolve_size(inputs, width, height):
    """The output size: the caller's, else the first input's (512x512
    without inputs). shape[-2]/[-3], so animated (T, H, W, 4) inputs and
    (N, H, W, 4) job stacks resolve too."""
    if width is None:
        width = inputs[0].shape[-2] if inputs else 512
    if height is None:
        height = inputs[0].shape[-3] if inputs else 512
    return int(width), int(height)


class Shared:
    """Marker wrapping ONE input every job of a render_batch samples
    (see `shared`)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def shared(value):
    """Mark a render_batch input as SHARED across the batch: one (H, W, C)
    image, or one (T, H, W, 4) animated stack, with NO job axis, that every
    job samples (the param-animation workload: N param or t values over
    one image). It is staged on the device once, before the job loop; the
    result equals the broadcast-stacked form bit for bit."""
    return Shared(value)


class Filter:
    """A compiled MathMap filter (plus the filter environment of its file)."""

    def __init__(self, program: A.Program, fdef: A.FilterDef, source: str | None = None):
        self.fdef = fdef
        self.filters = {f.name: f for f in program.filters}
        #: the MathMap source it was compiled from (generators/standalone.py)
        self.source = source

    # -- metadata -----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.fdef.name

    @property
    def params(self):
        return self.fdef.params

    @property
    def image_params(self):
        return [p for p in self.fdef.params if p.kind == "image"]

    # -- rendering ------------------------------------------------------------
    def render(self, *inputs, width: int | None = None, height: int | None = None,
               t: float = 0.0, frame: float = 0.0,
               options: RenderOptions | None = None, params: dict | None = None,
               interpret: bool = False, precision: str = "f32", on_error: str = "raise",
               device=None) -> torch.Tensor:
        """Render one frame -> (H, W, 4) tensor on `device` ("cuda" unless
        `interpret`): float32 in [0, 1], or uint8 with
        options.output_dtype='uint8'. With options.region = (x, y, w, h)
        only that selection is evaluated, with the full canvas's
        coordinates -> (h, w, 4), the full render's crop.

        inputs: (H, W, C) numpy arrays or (H, W, 4) float32/uint8 tensors,
        bound to the filter's image parameters in order; a 4-D one is an
        ANIMATED (T, H, W, 4) input, sampled at frame `frame` unless
        origValXY names another. The output size defaults to the first
        input's (512x512 without inputs).

        `interpret=True` renders on the CPU route, the kernels' plain
        versions (the reference's NumPy oracle path; a device other than
        the CPU raises ValueError). There `precision="f64"` renders the
        reference's float64 spec: the evaluation runs in float64 and the
        output is float64 (uint8 still packs to uint8); any other value is
        float32. Without `interpret` the render is float32 whatever
        `precision` says, as the reference's jit path ignores it.
        `on_error="interpret"`, the reference's silent CPU fallback after a
        failed device render, raises ValueError: a failure here always
        raises."""
        if on_error == "interpret":
            raise ValueError(
                "on_error='interpret' (a silent CPU fallback after a failed device "
                "render) is not supported: render with interpret=True to ask for "
                "the CPU")
        dtype = torch.float32
        if interpret:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(
                    f"interpret=True renders on the CPU, but device={device!r} was "
                    f"given: pass one of interpret=True and device=")
            dev = torch.device("cpu")
            if precision == "f64":
                dtype = torch.float64
        else:
            dev = resolve_device("cuda" if device is None else device)
        ins = [_stage_input(a, dev) for a in inputs]
        width, height = _resolve_size(ins, width, height)
        return render(self.filters, self.fdef, width, height,
                      options or RenderOptions(), dev, ins, params or {},
                      t=t, frame=frame, dtype=dtype)

    def render_batch(self, *batched_inputs, ts=None, frames=None,
                     width: int | None = None, height: int | None = None,
                     options: RenderOptions | None = None, params=None,
                     device="cuda") -> torch.Tensor:
        """Render N independent jobs -> (N, H, W, 4) tensor on `device`.

        Each batched input is an (N, H, W, C) stack (or a list of N (H, W,
        C) frames); job i renders the i-th slice of every input at
        t = ts[i] (default 0.0) with its `frame` internal frames[i]
        (default: the job index; pass zeros for a batch whose jobs equal
        their lone-render twins). Wrap an input in `shared(img)` to pass ONE
        image, or one (T, H, W, 4) animated stack, that every job samples.
        `params` is one dict for every job, or a list of N dicts with the
        same names. With only shared inputs the batch size comes from `ts`,
        else from a list of params, else 1. Each job equals its lone
        `render` bit for bit."""
        opts = options or RenderOptions()
        params = params or {}
        dev = resolve_device(device)
        mask = tuple(isinstance(b, Shared) for b in batched_inputs)
        # shared entries stage with render()'s rules: a 4-D shared array is
        # an ANIMATED stack, not a job axis
        ins = [_stage_input(b.value, dev) if m else _stage_batch(b, dev)
               for b, m in zip(batched_inputs, mask)]
        per_job = [a for a, m in zip(ins, mask) if not m]
        if per_job:
            n = int(per_job[0].shape[0])
        elif ts is not None:
            n = len(ts)
        elif isinstance(params, (list, tuple)):
            n = len(params)
        else:
            n = 1
        for a in per_job:
            if a.dim() != 4 or int(a.shape[0]) != n:
                raise ValueError("render_batch inputs must share a leading batch axis")
        if ts is not None and len(ts) != n:
            raise ValueError(f"render_batch: {len(ts)} ts for a batch of {n} jobs")
        if frames is not None and len(frames) != n:
            raise ValueError(f"render_batch: {len(frames)} frames for a batch of {n} jobs")
        if isinstance(params, (list, tuple)):
            if len(params) != n:
                raise ValueError(
                    f"render_batch: {len(params)} param dicts for a batch of {n} jobs")
            if any(set(p) != set(params[0]) for p in params):
                raise ValueError("render_batch: per-job params must declare the same "
                                 "names in every job")
        width, height = _resolve_size(ins, width, height)
        ts = np.zeros(n, np.float32) if ts is None else np.asarray(ts, np.float32)
        frames = (np.arange(n, dtype=np.float32) if frames is None
                  else np.asarray(frames, np.float32))
        return render_jobs(self.filters, self.fdef, width, height, opts, dev, ins, mask,
                           params, ts, frames)

    def render_animation(self, *inputs, num_frames: int, width: int | None = None,
                         height: int | None = None, options: RenderOptions | None = None,
                         params: dict | None = None, device="cuda") -> torch.Tensor:
        """A t-sweep of `num_frames` frames -> (F, H, W, 4) tensor on
        `device`: frame i at t = i/F (options.periodic) or i/(F-1), with its
        `frame` internal i; an animated input is sampled at frame i. The
        inputs are staged once, and each frame's last operation writes it
        into one preallocated output. For frame-by-frame streaming use
        render_frames()."""
        return render_jobs(*self._sweep(inputs, num_frames, width, height, options,
                                        params, device))

    def render_frames(self, *inputs, num_frames: int, width: int | None = None,
                      height: int | None = None, options: RenderOptions | None = None,
                      params: dict | None = None, device="cuda"):
        """Animation as a generator: yields the (H, W, 4) frames of
        render_animation's t-sweep one at a time, from inputs staged once."""
        yield from iter_jobs(*self._sweep(inputs, num_frames, width, height, options,
                                          params, device))

    def _sweep(self, inputs, num_frames, width, height, options, params, device):
        """The job arguments of a t-sweep of `num_frames` frames, its inputs
        staged once and shared by every frame."""
        opts = options or RenderOptions()
        dev = resolve_device(device)
        ins = [_stage_input(a, dev) for a in inputs]
        width, height = _resolve_size(ins, width, height)
        return (self.filters, self.fdef, width, height, opts, dev, ins, (True,) * len(ins),
                params or {}, animation_ts(num_frames, opts.periodic),
                np.arange(num_frames, dtype=np.float32))

    def render_sharded(self, *inputs, mesh=None, num_frames: int = 1,
                       width: int | None = None, height: int | None = None,
                       options: RenderOptions | None = None, ts=None, t: float = 0.0,
                       frame: float = 0.0, params: dict | None = None) -> torch.Tensor:
        """Render with the grid split over a mesh's rows/cols
        (parallel/shard.py): every tile renders its own grid, with each
        input copied to its device -> (H, W, 4) tensor on the mesh's first
        device. With num_frames > 1, a t-sweep (at `ts`, default
        render_animation's) whose frames split over the mesh's frame axis
        in contiguous blocks -> (F, H, W, 4) there. 4-D inputs are ANIMATED
        (T, H, W, 4) stacks. `mesh=None` puts every visible GPU on the row
        axis (and raises without one; a CPU mesh is
        make_mesh(devices=["cpu"] * n)). options.region raises ValueError:
        render() gives the crop, render_tiled() the selection in place.
        Over a mesh that spans processes (parallel/distributed.global_mesh)
        this rank renders only its own tiles -> a shard.LocalFrame of them,
        or for a sweep of its (F / nf, tile_h, tile_w, 4) frame shards."""
        from .parallel.mesh import make_mesh
        from .parallel.shard import render_frame_sharded, render_frames_sharded

        opts = options or RenderOptions()
        if mesh is None:
            mesh = make_mesh()
        ins = [_stage_input(a, mesh.first_local) for a in inputs]
        width, height = _resolve_size(ins, width, height)
        if num_frames == 1:
            return render_frame_sharded(mesh, self.filters, self.fdef, width, height, opts,
                                        ins, params or {}, t=t, frame=frame)
        if ts is None:
            ts = animation_ts(num_frames, opts.periodic)
        if len(ts) != num_frames:
            raise ValueError(f"render_sharded: {len(ts)} ts for {num_frames} frames")
        return render_frames_sharded(mesh, self.filters, self.fdef, width, height, opts,
                                     ins, params or {}, np.asarray(ts, np.float32))

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
        the output's geometry; an animated (T, H, W, 4) input shards every
        frame alike. The filter's displacement must be bounded by
        `halo`: "auto" infers the bound from the filter's AST
        (parallel/bounds.py), and check=True turns a violated bound into an
        MMRuntimeError instead of a silent clamp. `mesh=None` puts every
        visible GPU on the row axis. With options.region the output is the
        full canvas: the selection rendered in place, every other pixel
        input 0's current frame (in the output dtype; u8 in and out pass
        the input bytes through).

        Over a mesh that spans processes (parallel/distributed.global_mesh)
        every rank calls this alike, and each stages and renders only its
        own tiles, halo rows and columns crossing ranks -> a
        shard.LocalFrame of this rank's tiles. Each input is then an array
        or tensor every rank passes whole (only this rank's blocks are
        copied to its devices), or the LocalFrame of an earlier render over
        the same mesh, so a chain of filters runs on a canvas no rank
        holds."""
        from .parallel.halo import TiledRenderer
        from .parallel.mesh import make_mesh
        from .parallel.shard import LocalFrame

        if mesh is None:
            mesh = make_mesh()
        if mesh.spans_processes:
            # blocks are cut from the input where it lies (a host array
            # stays on the host), never staged whole on a device
            imgs = [a if isinstance(a, LocalFrame) else
                    _stage_input(a, a.device if isinstance(a, torch.Tensor) else "cpu")
                    for a in input_images]
        elif any(isinstance(a, LocalFrame) for a in input_images):
            raise ValueError("a LocalFrame input is the tiles of a mesh that spans processes; "
                             "render over that mesh")
        else:
            imgs = [_stage_input(a, mesh.devices[0, 0, 0]) for a in input_images]
        width, height = _resolve_size(imgs, width, height)
        for a in imgs:
            if tuple(a.shape[-3:-1]) != (height, width):
                raise ValueError(
                    f"tiled inputs must share the output geometry "
                    f"{height}x{width}; got {a.shape[-3]}x{a.shape[-2]}")
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
    return Filter(program, fdef, source)


def compile_file(path: str, main: str | None = None) -> Filter:
    with open(path) as f:
        return compile_source(f.read(), main=main)
