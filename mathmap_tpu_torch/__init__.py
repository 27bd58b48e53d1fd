"""mathmap_tpu_torch — the PyTorch and CUDA port of mathmap_tpu, for an
NVIDIA H100.

The JAX package `mathmap_tpu` stays the reference; this package imports
`torch` and never `jax` or `mathmap_tpu`. It renders the distortion suite
(filters/Distorts/fisheye, twirl, pond) and the generative filters
(filters/Render/mandelbrot and the escape-time fractals) end to end: the
front end is a copy of the reference's, the evaluator runs eager torch ops
on the device the caller names, origVal goes through a hand-written CUDA
sampler (csrc/sample_image.cu), curves and gradients through a CUDA LUT
kernel (csrc/apply_lut.cu), and each eligible `while` loop through a CUDA
kernel generated from its body (kernels/while_loop.py), all built by nvcc
at first use. `Filter.render_sharded` and `Filter.render_tiled` split a
render over a mesh of devices (`make_mesh`), the latter sampling each
tile's halo-extended input block through a CUDA kernel of its own
(csrc/sample_tiled.cu). `Filter.render_batch` renders N jobs (a
`shared()` input is one image every job samples), `render_animation` and
`render_frames` a t-sweep, and a 4-D input is an animated (T, H, W, 4)
stack. ROADMAP.md lists what is still to port.

    import mathmap_tpu_torch as mt
    f = mt.compile_file("filters/Distorts/twirl.mm")
    out = f.render(image, device="cuda")     # (H, W, 4) float32 tensor
"""

import sys as _sys

# Deep machine-generated expressions recurse through the parser and the
# evaluator, as in the reference.
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 20000))

from . import ops as _ops  # noqa: E402,F401  — populate the builtin registry
from .api import Filter, compile_file, compile_source, shared  # noqa: E402
from .parallel.mesh import make_mesh  # noqa: E402
from .runtime.options import RenderOptions  # noqa: E402
from .utils.errors import (  # noqa: E402
    MMError,
    MMNameError,
    MMRuntimeError,
    MMSyntaxError,
    MMTypeError,
)

compile = compile_source  # noqa: A001 — the reference's alias

__all__ = [
    "Filter",
    "shared",
    "compile",
    "compile_source",
    "compile_file",
    "make_mesh",
    "RenderOptions",
    "MMError",
    "MMSyntaxError",
    "MMTypeError",
    "MMNameError",
    "MMRuntimeError",
]
