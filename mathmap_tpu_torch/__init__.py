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
at first use and called as `torch.library` custom ops (`mathmap::`). `Filter.render_sharded` and `Filter.render_tiled` split a
render over a mesh of devices (`make_mesh`), the latter sampling each
tile's halo-extended input block through a CUDA kernel of its own
(csrc/sample_tiled.cu). `Filter.render_batch` renders N jobs (a
`shared()` input is one image every job samples), `render_animation` and
`render_frames` a t-sweep, and a 4-D input is an animated (T, H, W, 4)
stack. The vector, matrix, quaternion and special builtins and
`gaussian_blur` are there, and `default_db()` is the filter library of
filters/ (the `.mm` sources and the `.mmc` compositions of the composer,
designer/), each entry compiled with the whole library in scope.
`RenderOptions.region` renders a selection and
`supersample_scheme="corners"` the corner-grid antialiasing. The front
ends are the CLI (`python -m mathmap_tpu_torch`, with `--selftest`), the
render service (`python -m mathmap_tpu_torch.serve`) and the preview app
(`python -m mathmap_tpu_torch.preview`), over the package's own image I/O
(imgio/). `generators/` exports a filter as an artifact (.mmxa, a
`torch.export` program that loads without the compiler), a script or its
program's text, and `parallel/distributed.py` splits a render over the
ranks of a `torch.distributed` group. `render(interpret=True)` renders on
the CPU through the kernels' plain versions, and `precision="f64"` there
is the reference's float64 spec (runtime/promotion.py).

    import mathmap_tpu_torch as mt
    f = mt.compile_file("filters/Distorts/twirl.mm")
    out = f.render(image)                    # (H, W, 4) float32 on the card
    spec = f.render(image, interpret=True, precision="f64")  # CPU, float64
    g = mt.default_db().compile("dream_pond")  # a composition
"""

import importlib as _importlib
import sys as _sys

# Deep machine-generated expressions recurse through the parser and the
# evaluator, as in the reference.
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 20000))

#: public name -> the module that defines it. Imported at first use, so
#: importing a submodule alone (the artifact loader, generators/artifact.py)
#: loads no parser, evaluator or builtin table.
_EXPORTS = {
    "Filter": "api", "compile_file": "api", "compile_source": "api", "shared": "api",
    "ExpressionDB": "expression_db", "default_db": "expression_db",
    "read_image": "imgio.images", "write_image": "imgio.images",
    "to_float_rgba": "imgio.images", "to_uint8": "imgio.images",
    "make_mesh": "parallel.mesh",
    "RenderOptions": "runtime.options",
    "Curve": "runtime.value", "Gradient": "runtime.value", "InputImage": "runtime.value",
    "MMError": "utils.errors", "MMNameError": "utils.errors",
    "MMRuntimeError": "utils.errors", "MMSyntaxError": "utils.errors",
    "MMTypeError": "utils.errors",
}

__version__ = "0.1.0"


def __getattr__(name):
    if name == "compile":  # the reference's alias
        return __getattr__("compile_source")
    module = _EXPORTS.get(name)
    if module is None:  # a submodule not imported yet
        try:
            return _importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError:
            raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(_importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "Filter",
    "shared",
    "ExpressionDB",
    "default_db",
    "compile",
    "compile_source",
    "compile_file",
    "read_image",
    "write_image",
    "to_float_rgba",
    "to_uint8",
    "make_mesh",
    "RenderOptions",
    "Curve",
    "Gradient",
    "InputImage",
    "MMError",
    "MMSyntaxError",
    "MMTypeError",
    "MMNameError",
    "MMRuntimeError",
    "__version__",
]
