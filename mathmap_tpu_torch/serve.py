"""Render service: a coalescing job queue + HTTP front end (the port of
`mathmap_tpu/serve.py`).

- `RenderService`: a thread-safe job queue. A single dispatcher thread
  drains the queue, groups jobs that share a program signature (filter,
  size, options, param NAMES and input shapes and dtypes — values may
  differ per job via `render_batch`'s per-job params list; with
  static_params the values are constants of the render, so grouping falls
  back to values), and issues ONE `Filter.render_batch` call per group,
  with per-job params and frame 0, so each job equals its lone render bit
  for bit. Groups dispatch OLDEST-FIRST, so a minority signature is never
  starved by sustained traffic of another. Groups are not padded to
  power-of-2 sizes: the reference pads to bound its number of compiled
  programs, and this package compiles none; `batch_hist` records the
  true group size.
- Every tensor lives on the dispatcher thread: handler threads decode
  request images into host arrays (numpy) and submit; the dispatcher
  stages them on the device, renders on the device's current stream and
  copies the results back to the host.
- `serve()` / `python -m mathmap_tpu_torch.serve`: a stdlib
  ThreadingHTTPServer JSON API over the service.

Endpoints:
  GET  /healthz          {"ok": true, "platform": "cuda"|"cpu", "programs": N}
  GET  /stats            counters + batch-size histogram + latency
  POST /warmup           {"filter": name|{"source": src}, "width", "height",
                          "batch_sizes": [1, 4, ...], ...options} -> renders
                          one batch of each size
  POST /render           {"filter": ..., "width", "height", "t", "params",
                          "inputs": [base64 PNG, ...],
                          "format": "png"|"raw"} -> {"image": base64}
                          (raw: {"shape", "dtype", "data"}; uint8 by default)
  POST /animate          {"filter": ..., "num_frames", "fps", ...} ->
                          {"gif": base64} (GIF needs Pillow), or "format":
                          "raw" -> (F, H, W, 4) bytes + declared dtype
  GET  /artifacts        loaded .mmxa artifacts, their geometry and params

{"artifact": name} in place of "filter" on /render and /animate runs an
exported artifact loaded with `load_artifacts` (or `--artifacts PATH`):
no parser or evaluator at serve time, the geometry fixed at export.

Any render/animate request may set {"binary": true} to receive the bytes
directly (image/png, image/gif, or application/octet-stream with
X-Shape/X-Dtype headers) instead of base64-in-JSON, and "png_level" (0-9)
for the PNG's zlib effort. Requests are PNG (any format with Pillow).

The service renders with output_dtype='uint8' by default: the 8-bit pack
runs ON the device and decoded request images stay uint8, so both
transfer directions move 4x fewer bytes than float32.
RenderService(output_dtype='float32') restores raw float results.

The device is the GPU, or the CPU under MMTPU_PLATFORM=cpu or `--cpu`.
Client errors (bad JSON, unknown filter, bad params) return 400; render
timeouts 503; backend failures 500.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

from .runtime.options import RenderOptions

#: options forwarded from request JSON to RenderOptions. JSON arrays
#: become tuples (edge_color, static_params, region: RenderOptions is
#: frozen and hashable, and it joins the group signature).
_OPT_KEYS = ("interpolation", "edge_x", "edge_y", "edge_color",
             "supersample", "supersample_scheme", "pallas_precision",
             "periodic", "seed", "static_params", "region")


def _opts_from(req: dict) -> RenderOptions:
    kw = {k: tuple(req[k]) if isinstance(req[k], list) else req[k]
          for k in _OPT_KEYS if k in req}
    return RenderOptions(**kw)


def _params_key(params: dict, by_value: bool) -> tuple:
    """Grouping key for a job's params. render_batch accepts per-job param
    VALUES (a params list), so by default only the param NAMES and value
    SHAPES must match for jobs to share a dispatch; with static_params in
    play the values are constants of the render, so group by value."""
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(float(x) for x in v) if by_value else len(v)
        if isinstance(v, (int, float, bool)):
            return float(v) if by_value else 0
        return str(v)

    return tuple(sorted((str(k), norm(v)) for k, v in params.items()))


def _host_input(a) -> np.ndarray:
    """A request image -> a host (H, W, 4) or animated (T, H, W, 4) numpy
    array: uint8 stays uint8 (the render converts it on the device), any
    other dtype becomes float32; gray and RGB expand as render() does."""
    from .convert import _rgba

    arr = np.asarray(a)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(_rgba(arr))


@dataclass
class _Job:
    sig: Any
    filt: Any
    inputs: list  # host (H, W, 4) arrays (may be empty)
    t: float
    params: dict
    width: int
    height: int
    options: RenderOptions
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None
    enqueued: float = field(default_factory=time.perf_counter)
    #: not None -> an animation job: one render_animation call for the
    #: whole t-sweep (never grouped; its sig is unique)
    num_frames: int | None = None
    #: not None -> run this callable on the dispatcher thread (warmup)
    call: Any = None
    #: unique-sig jobs dispatch the moment the dispatcher sees them: a
    #: gathering window would add latency with no chance of a companion
    solo: bool = False
    #: not None -> a job of this LoadedArtifact (render_artifact)
    artifact: Any = None
    frame: float = 0.0


class RenderService:
    """Coalescing render queue over compiled filters.

    One dispatcher thread; jobs whose (filter, size, options, params,
    inputs) signature matches are rendered in a single `render_batch`
    call. `window_ms` is how long the dispatcher waits to gather
    companions for the first job of a group; `max_batch` bounds a group's
    size. `device` defaults to the front ends' (the GPU, or the CPU under
    MMTPU_PLATFORM=cpu); it raises without a GPU otherwise.
    """

    def __init__(self, db=None, max_batch: int = 32, window_ms: float = 4.0,
                 output_dtype: str = "uint8", device=None):
        from .api import platform_device, resolve_device
        from .expression_db import default_db

        self.device = platform_device() if device is None else resolve_device(device)
        self.db = db if db is not None else default_db()
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        #: the dtype every job renders at: 'uint8' (default) packs on the
        #: device, 'float32' returns the float results
        if output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be 'float32' or 'uint8'")
        self.output_dtype = output_dtype
        self._q: queue.Queue = queue.Queue()
        self._filters: dict = {}     # cache key -> Filter
        self.artifacts: dict = {}    # name -> LoadedArtifact (.mmxa)
        self._artifact_paths: dict = {}  # name -> abspath it was loaded from
        self._lock = threading.Lock()
        self.stats = {
            "jobs": 0, "dispatches": 0, "errors": 0,
            "batch_hist": {},        # batch size -> count
            "latency_ms_sum": 0.0,   # submit -> result, summed over jobs
        }
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mmtorch-dispatcher")
        self._thread.start()

    @property
    def platform(self) -> str:
        return self.device.type

    def _svc_opts(self, options: RenderOptions | None) -> RenderOptions:
        """Request options + the service's output dtype."""
        options = options or RenderOptions()
        if options.output_dtype != self.output_dtype:
            options = replace(options, output_dtype=self.output_dtype)
        return options

    # -- filter management -----------------------------------------------
    def get_filter(self, spec):
        """spec: a library filter name, or {"source": mm_source}."""
        from .api import compile_source

        if isinstance(spec, dict) and "source" in spec:
            key = ("src", spec["source"], spec.get("main"))
        else:
            key = ("name", str(spec))
        with self._lock:
            filt = self._filters.get(key)
            if filt is None:
                if key[0] == "src":
                    filt = compile_source(spec["source"], spec.get("main"))
                else:
                    filt = self.db.compile(str(spec))
                self._filters[key] = filt
            return filt

    def load_artifacts(self, path) -> list:
        """Register .mmxa artifacts (a file or a directory of them) under
        their exported filter names (the file stem on a collision); they
        must have been exported for this service's device type. Requests
        ({"artifact": name}) run the exported program: no parse and no
        evaluator at serve time, the geometry fixed at export. Artifacts
        exported with batch_sizes coalesce like live filters; the others
        dispatch as singletons."""
        import os

        from .generators.artifact import load_artifact

        files = ([os.path.join(path, f) for f in sorted(os.listdir(path))
                  if f.endswith(".mmxa")]
                 if os.path.isdir(path) else [path])
        names = []
        for f in files:
            art = load_artifact(f, platform=self.device.type)
            src = os.path.abspath(f)
            name = art.manifest.get("filter") or os.path.basename(f)
            if name in self.artifacts and self._artifact_paths.get(name) != src:
                name = os.path.splitext(os.path.basename(f))[0]
            if name in self.artifacts and self._artifact_paths.get(name) != src:
                # two different files claiming one name: refuse rather than
                # reroute the clients of the first
                raise ValueError(
                    f"artifact name {name!r} already serves "
                    f"{self._artifact_paths[name]}; rename {f} to load it")
            self.artifacts[name] = art
            self._artifact_paths[name] = src
            names.append(name)
        return names

    def _artifact(self, name: str):
        art = self.artifacts.get(name)
        if art is None:
            raise ValueError(f"unknown artifact {name!r}; loaded: {sorted(self.artifacts)}")
        return art

    @staticmethod
    def _check_artifact_request(art, inputs, params):
        """The artifact's own ValueErrors for bad inputs or params, raised
        before the job is queued, so a bad request never joins (and fails)
        a group."""
        m = art.manifest
        if len(inputs) != m["n_inputs"]:
            raise ValueError(
                f"artifact expects {m['n_inputs']} input image(s), got {len(inputs)}")
        for a in inputs:
            if np.shape(a) != (m["height"], m["width"], 4):
                raise ValueError(
                    f"artifact inputs must be ({m['height']}, {m['width']}, 4); "
                    f"got {np.shape(a)}")
        art._build_uv(params or {})

    def render_artifact(self, name: str, inputs, params: dict | None = None,
                        t: float = 0.0, frame: float = 0.0,
                        timeout: float | None = 600.0) -> np.ndarray:
        """Render a loaded artifact through the job queue -> a host array."""
        art = self._artifact(name)
        inputs = [_host_input(a) for a in inputs]
        self._check_artifact_request(art, inputs, params)
        sig = ("art", id(art)) if art.batch_sizes else ("art", id(art), object())
        job = self._put(_Job(sig=sig, filt=None, inputs=inputs, t=float(t),
                             params=params or {}, width=art.manifest["width"],
                             height=art.manifest["height"], options=RenderOptions(),
                             artifact=art, frame=float(frame), solo=not art.batch_sizes))
        return self._wait(job, timeout, "render")

    def animate_artifact(self, name: str, inputs, params: dict | None = None,
                         num_frames: int | None = None,
                         timeout: float | None = 600.0) -> np.ndarray:
        """Run a loaded artifact's exported sweep -> (F, H, W, 4) on the
        host; F is fixed at export, so a conflicting `num_frames` raises.
        Never grouped."""
        art = self._artifact(name)
        exported = art.manifest.get("anim_frames")
        if num_frames is not None and num_frames != exported:
            raise ValueError(
                f"artifact animation has {exported or 'no'} frames (fixed at export); "
                f"requested num_frames={num_frames}: re-export with anim_frames="
                f"{num_frames} or drop the field")
        if not exported:
            raise ValueError("artifact has no animation program; export with "
                             "anim_frames=F to enable render_animation")
        inputs = [_host_input(a) for a in inputs]
        self._check_artifact_request(art, inputs, params)
        job = self._put(_Job(sig=("art-anim", id(art), object()), filt=None, inputs=inputs,
                             t=0.0, params=params or {}, width=art.manifest["width"],
                             height=art.manifest["height"], options=RenderOptions(),
                             artifact=art, solo=True, num_frames=int(exported)))
        return self._wait(job, timeout, "animation")

    def warmup(self, spec, width: int, height: int,
               options: RenderOptions | None = None,
               params: dict | None = None, batch_sizes=(1,)):
        """Render one batch of each size in `batch_sizes` on the
        dispatcher thread (blocking): the kernels build on first use, so
        this moves their build and first launch out of a request."""
        filt = self.get_filter(spec)
        options = self._svc_opts(options)
        params = params or {}
        n_img = len(filt.image_params)

        def run():
            for n in batch_sizes:
                n = max(1, int(n))
                # u8 blanks: requests arrive as decoded uint8
                stacks = [np.zeros((n, height, width, 4), np.uint8) for _ in range(n_img)]
                filt.render_batch(*stacks, ts=np.zeros(n, np.float32),
                                  frames=np.zeros(n, np.float32), width=width,
                                  height=height, options=options, params=[params] * n,
                                  device=self.device).cpu()

        self._wait(self._put(_Job(sig=object(), filt=filt, inputs=[], t=0.0, params=params,
                                  width=width, height=height, options=options, call=run,
                                  solo=True)), 600.0, "warmup")
        return filt

    # -- job path ----------------------------------------------------------
    def submit(self, spec, inputs, width: int, height: int, t: float = 0.0,
               params: dict | None = None,
               options: RenderOptions | None = None,
               num_frames: int | None = None) -> _Job:
        filt = self.get_filter(spec)
        params = params or {}
        options = self._svc_opts(options)
        inputs = [_host_input(a) for a in inputs]
        # Grouping keys on param NAMES (render_batch takes per-job values)
        # except under static_params. Input shapes and dtypes join the
        # signature: a batch stacks its inputs, and a u8 frame stacked
        # with a float32 one would be promoted. Animated (T, H, W, 4)
        # inputs and animations dispatch alone.
        shapes = tuple((a.shape, str(a.dtype)) for a in inputs)
        animated = any(a.ndim == 4 for a in inputs)
        solo = animated or num_frames is not None
        sig = (id(filt), width, height, options,
               _params_key(params, by_value=bool(options.static_params)),
               shapes, object() if solo else None)
        return self._put(_Job(sig=sig, filt=filt, inputs=inputs, t=float(t), params=params,
                              width=width, height=height, options=options,
                              num_frames=num_frames, solo=solo))

    def _put(self, job: _Job) -> _Job:
        self._q.put(job)
        return job

    @staticmethod
    def _wait(job: _Job, timeout, what: str):
        if not job.done.wait(timeout):
            raise TimeoutError(f"{what} timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def render_sync(self, spec, inputs, width: int, height: int,
                    t: float = 0.0, params: dict | None = None,
                    options: RenderOptions | None = None,
                    timeout: float | None = 600.0) -> np.ndarray:
        job = self.submit(spec, inputs, width, height, t, params, options)
        return self._wait(job, timeout, "render")

    def animate_sync(self, spec, inputs, width: int, height: int,
                     num_frames: int, params: dict | None = None,
                     options: RenderOptions | None = None,
                     timeout: float | None = 600.0) -> np.ndarray:
        """Whole t-sweep through render_animation -> (F, H, W, 4). Queued
        like any job (it serialises device access) but never grouped."""
        job = self.submit(spec, inputs, width, height, 0.0, params, options,
                          num_frames=int(num_frames))
        return self._wait(job, timeout, "animation")

    # -- dispatcher --------------------------------------------------------
    def _run(self):
        import torch

        # pending groups live HERE, not on the queue; groups dispatch
        # oldest-first, each when its window expires or it fills
        pending: dict = {}  # sig -> list[_Job], each list enqueue-ordered
        device_ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
                      else contextlib.nullcontext())
        with device_ctx:
            while not self._stop.is_set():
                try:
                    j = self._q.get(timeout=0.005 if pending else 0.1)
                    pending.setdefault(j.sig, []).append(j)
                    while True:  # drain whatever else arrived, without blocking
                        try:
                            j = self._q.get_nowait()
                        except queue.Empty:
                            break
                        pending.setdefault(j.sig, []).append(j)
                except queue.Empty:
                    pass
                if not pending:
                    continue
                solos = sorted((s for s, g in pending.items() if g[0].solo),
                               key=lambda s: pending[s][0].enqueued)
                for s in solos:
                    self._dispatch(pending.pop(s))
                if not pending:
                    continue
                sig, group = min(pending.items(), key=lambda kv: kv[1][0].enqueued)
                now = time.perf_counter()
                if (len(group) < self.max_batch
                        and now - group[0].enqueued < self.window_ms / 1e3):
                    continue  # the oldest group's window is still open
                rest = group[self.max_batch:]
                if rest:
                    pending[sig] = rest
                else:
                    del pending[sig]
                self._dispatch(group[:self.max_batch])
        # unblock anything still waiting at shutdown
        for group in pending.values():
            for g in group:
                g.error = RuntimeError("service shut down")
                g.done.set()

    def _dispatch(self, group: list):
        try:
            j0 = group[0]
            if j0.call is not None:
                j0.call()
            elif j0.artifact is not None:
                self._dispatch_artifact(group)
            elif len(group) == 1 and j0.num_frames is not None:
                j0.result = j0.filt.render_animation(
                    *j0.inputs, num_frames=j0.num_frames, width=j0.width,
                    height=j0.height, params=j0.params, options=j0.options,
                    device=self.device).cpu().numpy()
            elif len(group) == 1:
                j0.result = j0.filt.render(
                    *j0.inputs, width=j0.width, height=j0.height, t=j0.t,
                    params=j0.params, options=j0.options, device=self.device).cpu().numpy()
            else:
                n = len(group)
                stacks = [np.stack([g.inputs[i] for g in group])
                          for i in range(len(j0.inputs))]
                # a lone render runs at frame 0: its batched twin does too
                outs = j0.filt.render_batch(
                    *stacks, ts=np.asarray([g.t for g in group], np.float32),
                    frames=np.zeros(n, np.float32), width=j0.width, height=j0.height,
                    params=[g.params for g in group], options=j0.options,
                    device=self.device).cpu().numpy()
                for i, g in enumerate(group):
                    g.result = outs[i]
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for g in group:
                g.error = e
            with self._lock:
                self.stats["errors"] += len(group)
        finally:
            now = time.perf_counter()
            if group[0].call is None:
                with self._lock:
                    self.stats["jobs"] += len(group)
                    self.stats["dispatches"] += 1
                    h = self.stats["batch_hist"]
                    h[str(len(group))] = h.get(str(len(group)), 0) + 1
                    for g in group:
                        self.stats["latency_ms_sum"] += (now - g.enqueued) * 1e3
            for g in group:
                g.done.set()

    @staticmethod
    def _dispatch_artifact(group: list):
        """Artifact jobs: one render_batch call per chunk of at most the
        largest exported batch size, else each job alone."""
        art = group[0].artifact
        if group[0].num_frames is not None:
            (g,) = group  # animation sigs are unique: never grouped
            g.result = art.render_animation(*g.inputs, params=g.params).cpu().numpy()
            return
        if len(group) == 1 or not art.batch_sizes:
            for g in group:
                g.result = art.render(*g.inputs, params=g.params, t=g.t,
                                      frame=g.frame).cpu().numpy()
            return
        cap = max(art.batch_sizes)
        for s in range(0, len(group), cap):
            chunk = group[s:s + cap]
            stacks = [np.stack([g.inputs[i] for g in chunk]) for i in range(len(chunk[0].inputs))]
            outs = art.render_batch(
                *stacks, params=[g.params for g in chunk],
                ts=np.asarray([g.t for g in chunk], np.float32),
                frames=np.asarray([g.frame for g in chunk], np.float32)).cpu().numpy()
            for g, o in zip(chunk, outs):
                g.result = o

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s["batch_hist"] = dict(self.stats["batch_hist"])
            s["programs"] = len(self._filters)
            if s["jobs"]:
                s["mean_latency_ms"] = round(s.pop("latency_ms_sum") / s["jobs"], 2)
            else:
                s.pop("latency_ms_sum")
        return s

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _decode_input(b64: str) -> np.ndarray:
    """A base64 request image -> host uint8 (H, W, 4), or an animated
    (T, H, W, 4) stack for a multi-frame file."""
    from .imgio.images import read_animation

    stack = read_animation(io.BytesIO(base64.b64decode(b64)), as_uint8=True)
    return stack[0] if stack.shape[0] == 1 else stack


def make_handler(service: RenderService):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _binary(self, data: bytes, ctype: str, headers: dict = None):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_raw(self, arr: np.ndarray, req: dict):
            data = np.ascontiguousarray(arr).tobytes()
            if req.get("binary"):
                return self._binary(
                    data, "application/octet-stream",
                    {"X-Shape": ",".join(map(str, arr.shape)), "X-Dtype": str(arr.dtype)})
            return self._json(200, {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                    "data": base64.b64encode(data).decode()})

        def _send_array(self, arr: np.ndarray, req: dict):
            """/render's response tail: raw|png x json|binary."""
            from .imgio.images import to_uint8
            from .imgio.png import encode_png

            if req.get("format") == "raw":
                return self._send_raw(arr, req)
            png = encode_png(to_uint8(arr), int(req.get("png_level", 1)))
            if req.get("binary"):
                return self._binary(png, "image/png")
            return self._json(200, {"image": base64.b64encode(png).decode()})

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "platform": service.platform,
                                 "programs": len(service._filters)})
            elif self.path == "/stats":
                self._json(200, service.snapshot())
            elif self.path == "/artifacts":
                self._json(200, {
                    name: {"width": a.manifest["width"], "height": a.manifest["height"],
                           "n_inputs": a.manifest["n_inputs"],
                           "params": sorted(a.manifest["params"]),
                           "platforms": list(a.platforms)}
                    for name, a in service.artifacts.items()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/warmup":
                    filt = service.warmup(
                        req["filter"], int(req.get("width", 256)),
                        int(req.get("height", 256)), _opts_from(req),
                        req.get("params"),
                        batch_sizes=tuple(req.get("batch_sizes", (1,))))
                    return self._json(200, {"ok": True, "filter": filt.name})
                if self.path not in ("/render", "/animate"):
                    return self._json(404, {"error": "unknown path"})
                inputs = [_decode_input(b) for b in req.get("inputs", [])]
                if "artifact" in req and self.path == "/render":
                    out = service.render_artifact(
                        req["artifact"], inputs, params=req.get("params"),
                        t=float(req.get("t", 0.0)), frame=float(req.get("frame", 0.0)))
                    return self._send_array(out, req)
                w = int(req.get("width") or (inputs[0].shape[-2] if inputs else 256))
                h = int(req.get("height") or (inputs[0].shape[-3] if inputs else 256))
                if self.path == "/render":
                    out = service.render_sync(
                        req["filter"], inputs, w, h, t=float(req.get("t", 0.0)),
                        params=req.get("params"), options=_opts_from(req))
                    return self._send_array(out, req)
                if "artifact" in req:
                    # the exported sweep: F fixed at export, a conflicting
                    # num_frames is a 400
                    nf = req.get("num_frames")
                    frames = service.animate_artifact(
                        req["artifact"], inputs, params=req.get("params"),
                        num_frames=None if nf is None else int(nf))
                else:
                    frames = service.animate_sync(
                        req["filter"], inputs, w, h, num_frames=int(req.get("num_frames", 8)),
                        params=req.get("params"), options=_opts_from(req))
                if req.get("format") == "raw":
                    return self._send_raw(frames, req)
                from .imgio.images import encode_gif

                gif = encode_gif(frames, float(req.get("fps", 25)), palette=False,
                                 disposal=None)
                if req.get("binary"):
                    return self._binary(gif, "image/gif")
                return self._json(200, {"gif": base64.b64encode(gif).decode()})
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except TimeoutError as e:
                # the device stalled: a retryable server condition
                return self._json(503, {"error": f"render timed out: {e}"})
            except Exception as e:  # noqa: BLE001
                from .utils.errors import MMError

                # caller mistakes (bad source, unknown filter/param, bad
                # values) are 4xx; backend failures are 5xx
                code = 400 if isinstance(e, (MMError, ValueError, TypeError,
                                             KeyError)) else 500
                return self._json(code, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(port: int = 8723, host: str = "127.0.0.1",
          service: RenderService | None = None, block: bool = True):
    """Start the HTTP render service; returns (httpd, service)."""
    from http.server import ThreadingHTTPServer

    service = service or RenderService()
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if block:
        try:
            httpd.serve_forever()
        finally:
            service.shutdown()
    return httpd, service


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="mathmap_tpu_torch render service")
    ap.add_argument("--port", type=int, default=8723)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--window-ms", type=float, default=4.0)
    ap.add_argument("--output-dtype", choices=("uint8", "float32"),
                    default="uint8",
                    help="render dtype for every dispatch (uint8 packs "
                         "on the device, 4x less readback; float32 restores "
                         "raw float results for raw-format clients)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (like MMTPU_PLATFORM=cpu)")
    ap.add_argument("--artifacts", default=None, metavar="PATH",
                    help="load .mmxa artifacts (a file or a directory) as "
                         "exported programs ({'artifact': name} on /render "
                         "and /animate; GET /artifacts lists them)")
    args = ap.parse_args(argv)
    from .api import platform_device

    try:
        device = "cpu" if args.cpu else platform_device()
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(str(exc))
    svc = RenderService(max_batch=args.max_batch, window_ms=args.window_ms,
                        output_dtype=args.output_dtype, device=device)
    if args.artifacts:
        names = svc.load_artifacts(args.artifacts)
        print(f"loaded {len(names)} artifact(s): {', '.join(names)}", flush=True)
    print(f"serving on http://{args.host}:{args.port} on {svc.device}  "
          f"(max_batch={args.max_batch}, window={args.window_ms}ms)", flush=True)
    serve(args.port, args.host, svc)


if __name__ == "__main__":
    main()
