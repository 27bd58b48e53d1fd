"""Exported artifacts: a filter's frame program written to one file
(.mmxa) and loaded without the compiler (the port of
`mathmap_tpu/generators/artifact.py`).

`export_artifact` traces one (filter, geometry, options, param NAMES)
configuration with `torch.export` on the device it is given and writes a
JSON manifest (geometry, param spec, input count, torch version) and the
serialised `ExportedProgram`. The program takes the input images, one
tensor per param leaf (a slider, a colour component, a curve or gradient
LUT), `t` and `frame`, so a param value or a time changes at call time
without a new export. The hand-written kernels are custom ops inside it:
`mathmap::sample_image` (B1), `mathmap::apply_lut` (B2),
`mathmap::while_loop` (B3, whose first argument is the loop's traced op
list as text), `mathmap::finish_rgba` (B5, the frame's finish, on either
device) and `mathmap::perlin3` (B6, a `noise` call), with `mathmap::libm`
for the CPU's numpy transcendentals (ops/libm.py).
`load_artifact` imports torch, numpy and the modules that register those
ops, and nothing else of the package: no parser, evaluator or builtin
table.

A loop goes into the program as the live render runs it: unrolled when
its trip count folds at trace time, as kernel B3's op when B3 takes it,
and otherwise (a body that calls noise, an image, a user filter, atan or
a special function, or holds another loop) as torch's `while_loop` op,
whose body graph holds the masked steps of the live route and calls B1 and
B2 as ops (runtime/loops.py::while_loop_exported). A B3 kernel is
generated from its op list, so loading an artifact with such a loop on the
card builds it with nvcc the first time (seconds; the library is cached on
disk by a hash of its source, kernels/build.py), at load time, not at the
first render.

The file keeps the reference's framing: `MMXA1\\n`, a `<I` manifest
length, the manifest, then u64-length-prefixed blobs (here one: the frame
program, whose `platforms` is the device it was traced on, "cuda" or
"cpu"). `render_batch` and `render_animation` run that frame program once
per job or frame: the live port's batch and sweep are the same loop of
lone renders (runtime/render.iter_jobs), so each result equals the live
one bit for bit. `batch_sizes` and `anim_frames` keep the reference's
contract: a batch may not exceed the largest exported size, and the
animation's frame count and t spacing are fixed at export.
"""

from __future__ import annotations

import io
import json
import os
import struct

import numpy as np
import torch

# register the custom ops an exported program calls
from ..kernels import apply_lut as _b2  # noqa: F401
from ..kernels import finish_rgba as _b5  # noqa: F401
from ..kernels import perlin3 as _b6  # noqa: F401
from ..kernels import sample_image as _b1
from ..kernels import while_loop as _b3
from ..ops import libm as _libm  # noqa: F401

_MAGIC = b"MMXA1\n"
#: param kinds whose value is a tuple of float32 scalars
_NUMERIC = ("int", "float", "bool", "color")


def _leaf_spec(a) -> dict:
    return {"shape": list(a.shape), "dtype": str(a.dtype).replace("torch.", "")}


def _current_platform() -> str:
    """The device this process renders on: the CPU under MMTPU_PLATFORM=cpu
    or without a GPU, else cuda (api.platform_device's rule)."""
    if os.environ.get("MMTPU_PLATFORM") == "cpu" or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


class _FrameProgram(torch.nn.Module):
    """One frame of `filt` as a module for torch.export: forward(images,
    leaves, t, frame) -> the frame, every param in `layout` bound from its
    leaves, the rest at their defaults or (static_params) baked."""

    def __init__(self, filt, width: int, height: int, opts, device, layout, baked: dict):
        super().__init__()
        self.filt, self.width, self.height, self.opts = filt, width, height, opts
        self.device, self.layout, self.baked = device, layout, baked

    def forward(self, images, leaves, t, frame):
        from ..runtime.render import region_fields, render_frame, resolve_region
        from ..runtime.tracer import RenderContext
        from ..runtime.uservals import convert_userval
        from ..runtime.value import (Curve, Gradient, InputImage, TupleValue, curve_value,
                                     gradient_value, image_value)
        from ..typesys.tags import NIL

        ctx = RenderContext(
            device=self.device, width=self.width, height=self.height, opts=self.opts,
            filters=self.filt.filters, t=t, frame=frame,
            inputs=[InputImage(pixels=a, name=f"in{i}") for i, a in enumerate(images)],
            **region_fields(resolve_region(self.opts, self.width, self.height)))
        declared = {p.name: p for p in self.filt.params}
        uv = {name: convert_userval(ctx, declared[name], v) for name, v in self.baked.items()}
        it = iter(leaves)
        for name, kind, n in self.layout:
            if kind in _NUMERIC:
                uv[name] = TupleValue("rgba" if kind == "color" else NIL, tuple(
                    next(it) for _ in range(n)))
            elif kind == "curve":
                uv[name] = curve_value(Curve(lut=next(it)))
            elif kind == "gradient":
                uv[name] = gradient_value(Gradient(lut=next(it)))
            else:
                uv[name] = image_value(InputImage(pixels=next(it), name=name))
        return render_frame(ctx, self.filt.fdef, uv)


def _export(filt, width: int, height: int, opts, device, params: dict):
    """Trace the frame program -> (ExportedProgram, manifest params spec)."""
    from ..runtime.render import resolve_region, validate_params
    from ..runtime.tracer import RenderContext
    from ..runtime.uservals import convert_userval

    validate_params(filt.fdef, params, opts.static_params)
    resolve_region(opts, width, height)
    ctx = RenderContext(device=device, width=width, height=height, opts=opts)
    layout, spec, leaves, baked = [], {}, [], {}
    for p in filt.params:
        if p.name not in params:
            continue
        if p.name in opts.static_params:
            baked[p.name] = params[p.name]
            continue
        tv = convert_userval(ctx, p, params[p.name])
        if p.kind in _NUMERIC:
            arrays = list(tv.arrays)
            spec[p.name] = {"tuple": [_leaf_spec(a) for a in arrays], "kind": p.kind,
                            "lo": p.lo, "hi": p.hi}
        else:
            arrays = [tv.payload.lut if p.kind in ("curve", "gradient") else tv.payload.pixels]
            spec[p.name] = {"array": _leaf_spec(arrays[0]), "kind": p.kind}
        layout.append((p.name, p.kind, len(arrays)))
        leaves += arrays
    images = [torch.zeros((height, width, 4), dtype=torch.float32, device=device)
              for _ in filt.image_params]
    scalar = torch.zeros((), dtype=torch.float32, device=device)
    module = _FrameProgram(filt, width, height, opts, device, layout, baked)
    with torch.no_grad():
        program = torch.export.export(module, (images, leaves, scalar, scalar.clone()),
                                      strict=False)
    return program, spec


def export_artifact(filt, path: str, width: int, height: int, options=None,
                    params: dict | None = None, batch_sizes=(), anim_frames: int | None = None,
                    device="cuda") -> None:
    """Write a .mmxa artifact of `filt` at the given geometry, traced on
    `device` ("cuda" by default; the artifact runs on that device type).

    `params` supplies a VALUE for every param that should be a runtime
    input of the artifact (the value only shapes the trace: a curve's LUT
    length, say); params omitted here render at their declared defaults,
    and names in options.static_params are baked with their value. Image
    params become positional inputs of the loaded artifact.

    `batch_sizes` lets the loaded artifact's `render_batch` take batches up
    to the largest size; `anim_frames=F` lets its `render_animation` render
    the F-frame t-sweep, its t spacing (options.periodic) fixed here."""
    from ..api import resolve_device
    from ..runtime.options import RenderOptions

    opts = options or RenderOptions()
    if anim_frames is not None and int(anim_frames) < 1:
        raise ValueError(f"anim_frames must be >= 1, got {anim_frames}")
    dev = resolve_device(device)
    program, spec = _export(filt, int(width), int(height), opts, dev, dict(params or {}))
    manifest = {
        "filter": filt.name,
        "width": int(width), "height": int(height),
        "n_inputs": len(filt.image_params),
        "platforms": [dev.type],
        "params": spec,
        "interpolation": opts.interpolation,
        "edges": [opts.edge_x, opts.edge_y],
        "has_grids": False,
        "batch_sizes": [int(n) for n in batch_sizes],
        "anim_frames": int(anim_frames) if anim_frames is not None else None,
        "periodic": bool(opts.periodic),
        "region": list(opts.region) if opts.region is not None else None,
        "torch": torch.__version__,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    head = json.dumps(manifest).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)


def _host_float(a) -> np.ndarray:
    """An input image -> float32, uint8 normalised by /255 as every render
    entry point does (float32 division: the sampler's u8 tap values)."""
    arr = np.asarray(a)
    return arr.astype(np.float32) / np.float32(255.0) if arr.dtype == np.uint8 else \
        np.asarray(arr, dtype=np.float32)


class LoadedArtifact:
    """A deserialised .mmxa: `render(*inputs, params=..., t=, frame=)` ->
    the frame as a tensor on the artifact's device.

    `inputs` are (H, W, 4) arrays or tensors of the exported geometry
    (uint8 normalised /255); `params` gives a value for every param in the
    manifest: numbers and bools, 3 or 4 components for a colour, a 1-D LUT
    for a curve, an (N, 4) or (N, 3) array for a gradient, of the shapes
    exported. Numbers are converted as the live render converts them
    (int rounding, clamping to the declared range)."""

    def __init__(self, manifest: dict, program):
        self.manifest = manifest
        self._program = program
        self._run = program.module()
        platform = self.platforms[0] if self.platforms else "cpu"
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if platform == "cuda" else torch.device(platform))
        #: the loops' op lists, whose kernels a cuda artifact builds here
        self.loops = [node.args[0] for node in program.graph.nodes
                      if node.target is torch.ops.mathmap.while_loop.default]
        if self.device.type == "cuda":
            for text in self.loops:
                _b3.build_program(text)

    @property
    def batch_sizes(self) -> tuple:
        return tuple(sorted(self.manifest.get("batch_sizes", [])))

    @property
    def platforms(self):
        return tuple(self.manifest.get("platforms", ()))

    def _build_uv(self, params: dict) -> list:
        """The param values -> the program's leaves (numpy), in manifest
        order, converted as runtime/uservals.convert_userval converts them."""
        spec = self.manifest["params"]
        params = params or {}
        unknown = set(params) - set(spec)
        if unknown:
            raise ValueError(
                f"artifact has no param(s) {sorted(unknown)}; exported "
                f"params: {sorted(spec)}")
        leaves = []
        for name, leaf in spec.items():
            if name not in params:
                raise ValueError(
                    f"artifact param {name!r} needs a value (it was "
                    f"exported as a runtime input)")
            v = params[name]
            if "tuple" in leaf:
                shapes = leaf["tuple"]
                if isinstance(v, (np.ndarray, torch.Tensor)):
                    vals = list(np.asarray(v).reshape(-1))
                elif isinstance(v, (list, tuple)):
                    vals = list(v)
                else:
                    vals = [v]
                kind = leaf["kind"]
                if kind == "color" and len(vals) == 3:
                    vals = vals + [1.0]  # rgb -> rgba like the live path
                if len(vals) != len(shapes):
                    raise ValueError(
                        f"param {name!r} expects {len(shapes)} components, "
                        f"got {len(vals)}")
                if kind == "bool":
                    vals = [1.0 if vals[0] else 0.0]
                elif kind != "color":
                    x = float(vals[0])
                    if kind == "int":
                        x = float(int(round(x)))
                    if leaf["lo"] is not None:
                        x = max(x, leaf["lo"])
                    if leaf["hi"] is not None:
                        x = min(x, leaf["hi"])
                    vals = [x]
                leaves += [np.asarray(float(x), dtype=np.float32) for x in vals]
                continue
            s = leaf["array"]
            arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
            arr = arr.astype(s["dtype"])
            if leaf["kind"] == "gradient" and arr.ndim == 2 and arr.shape[1] == 3:
                arr = np.concatenate([arr, np.ones((arr.shape[0], 1), arr.dtype)], axis=1)
            if list(arr.shape) != s["shape"]:
                raise ValueError(
                    f"param {name!r} expects shape {s['shape']} "
                    f"{s['dtype']}, got {list(arr.shape)}")
            leaves.append(np.ascontiguousarray(arr))
        return leaves

    def _stage(self, inputs) -> list:
        """Input images -> float32 (H, W, 4) tensors on the device."""
        m = self.manifest
        if len(inputs) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input image(s), got "
                f"{len(inputs)}")
        out = []
        for a in inputs:
            if isinstance(a, torch.Tensor):
                a = a.to(self.device)
                a = _b1.u8_to_float(a) if a.dtype == torch.uint8 else a.to(torch.float32)
            else:
                a = torch.from_numpy(np.ascontiguousarray(_host_float(a))).to(self.device)
            if tuple(a.shape) != (m["height"], m["width"], 4):
                raise ValueError(
                    f"artifact inputs must be ({m['height']}, "
                    f"{m['width']}, 4); got {tuple(a.shape)}")
            out.append(a.contiguous())
        return out

    def _frame(self, images, leaves, t, frame, out=None) -> torch.Tensor:
        dev = self.device
        result = self._run(images, [torch.from_numpy(v).to(dev) for v in leaves],
                           torch.tensor(float(t), dtype=torch.float32, device=dev),
                           torch.tensor(float(frame), dtype=torch.float32, device=dev))
        return result if out is None else out.copy_(result)

    def render(self, *inputs, params: dict | None = None, t: float = 0.0,
               frame: float = 0.0) -> torch.Tensor:
        """One frame at `t` with its `frame` internal -> (H, W, 4), or the
        region's (h, w, 4), on the artifact's device."""
        images = self._stage(inputs)
        return self._frame(images, self._build_uv(params or {}), t, frame)

    def _jobs(self, n: int, dtype) -> torch.Tensor:
        m = self.manifest
        region = m.get("region")
        h, w = (region[3], region[2]) if region else (m["height"], m["width"])
        return torch.empty((n, h, w, 4), dtype=dtype, device=self.device)

    def render_animation(self, *inputs, params: dict | None = None) -> torch.Tensor:
        """The exported t-sweep -> (F, H, W, 4): frame i at t = i/F
        (periodic) or i/(F-1) and its `frame` internal i, F and the spacing
        fixed at export (anim_frames)."""
        m = self.manifest
        if not m.get("anim_frames"):
            raise ValueError(
                "artifact has no animation program; export with "
                "anim_frames=F to enable render_animation")
        images = self._stage(inputs)
        leaves = self._build_uv(params or {})
        n = int(m["anim_frames"])
        denom = n if m.get("periodic") else max(n - 1, 1)
        ts = np.arange(n, dtype=np.float32) / denom
        out = None
        for i in range(n):
            frame = self._frame(images, leaves, ts[i], i)
            out = self._jobs(n, frame.dtype) if out is None else out
            out[i].copy_(frame)
        return out

    def render_batch(self, *input_stacks, params, ts, frames=None) -> torch.Tensor:
        """N independent jobs -> (N, H, W, 4): job i renders slice i of
        every (N, H, W, 4) stack at t=ts[i] with params[i] (`params` may be
        ONE dict for every job) and its `frame` internal frames[i] (default
        the job index). N may not exceed the largest exported batch size;
        each job runs the frame program, so it needs no padding."""
        m = self.manifest
        if not self.batch_sizes:
            raise ValueError(
                "artifact has no batched programs; export with "
                "batch_sizes=(...) to enable render_batch")
        ts = np.asarray(ts, np.float32).reshape(-1)
        n = int(ts.shape[0])
        params = [params] * n if isinstance(params, dict) else list(params)
        if len(params) != n:
            raise ValueError(
                f"render_batch: {len(params)} param dicts for {n} jobs")
        if len(input_stacks) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input stack(s), got "
                f"{len(input_stacks)}")
        stacks = []
        for a in input_stacks:
            if np.shape(a)[:1] != (n,) or len(np.shape(a)) != 4:
                raise ValueError(
                    f"input stacks must be ({n}, {m['height']}, "
                    f"{m['width']}, 4); got {tuple(np.shape(a))}")
            stacks.append(a)
        frames = (np.arange(n, dtype=np.float32) if frames is None
                  else np.asarray(frames, np.float32).reshape(-1))
        if frames.shape[0] != n:
            raise ValueError(
                f"render_batch: {frames.shape[0]} frame values for {n} jobs")
        if n > max(self.batch_sizes):
            raise ValueError(
                f"batch of {n} exceeds the largest exported batch size "
                f"{max(self.batch_sizes)}; chunk the batch or re-export")
        leaves = [self._build_uv(p) for p in params]
        out = None
        for i in range(n):
            frame = self._frame(self._stage([s[i] for s in stacks]), leaves[i], ts[i],
                                frames[i])
            out = self._jobs(n, frame.dtype) if out is None else out
            out[i].copy_(frame)
        return out


def _check_platform(platforms, current: str, path: str) -> None:
    """An exported program runs on the device type it was traced on; a
    mismatch fails at LOAD time, with re-export guidance."""
    plats = tuple(p.lower() for p in platforms)
    if plats and current.lower() not in plats:
        raise ValueError(
            f"{path}: artifact was exported for platform(s) "
            f"{list(plats)} but this process runs on "
            f"{current.lower()!r}. An exported program is pinned to the "
            f"device it was traced on: re-export the artifact on this "
            f"platform (python -m mathmap_tpu_torch ... --export-artifact or "
            f"export_artifact(..., device=...)), or serve it on "
            f"{'/'.join(plats)}.")


def load_artifact(path: str, platform: str | None = None) -> LoadedArtifact:
    """Load a .mmxa written by export_artifact (torch + numpy and the
    kernels' op modules only). Raises ValueError for a file that is not an
    artifact or is cut short, for one exported for another platform than
    `platform` ("cuda" or "cpu"; default: this process's, the CPU under
    MMTPU_PLATFORM=cpu or without a GPU), and for a program this torch
    cannot read back."""

    def read(f, n):
        raw = f.read(n)
        if len(raw) < n:
            raise ValueError(f"{path}: truncated artifact")
        return raw

    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a mathmap_tpu artifact")
        (n,) = struct.unpack("<I", read(f, 4))
        try:
            manifest = json.loads(read(f, n))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: corrupt artifact manifest") from e
        _check_platform(manifest.get("platforms", ()), platform or _current_platform(), path)
        (bn,) = struct.unpack("<Q", read(f, 8))
        blob = read(f, bn)
    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as e:  # noqa: BLE001 — any failure to read the program back
        raise ValueError(
            f"{path}: its exported program does not load in torch {torch.__version__} "
            f"(exported with torch {manifest.get('torch')}): {e}. Re-export the "
            f"artifact with this torch.") from e
    return LoadedArtifact(manifest, program)
