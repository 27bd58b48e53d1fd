"""The PyTorch port imports and renders with JAX blocked, and never loads the
JAX package (the card's machine has neither jax nor Pillow): the unsharded
renders, and the tiled and sharded renders of mathmap_tpu_torch.parallel on
a CPU mesh. Its public names are the reference's plus `make_mesh`, each
imported from its module at first use."""

import ast
import os
import subprocess
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(__file__), "..")

_BLOCKED_RUN = r"""
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "PIL"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import numpy as np

import mathmap_tpu_torch as mt
import mathmap_tpu_torch.convert  # noqa: F401
import mathmap_tpu_torch.kernels.build  # noqa: F401
import mathmap_tpu_torch.kernels.sample_image  # noqa: F401
from mathmap_tpu_torch.utils.trace import counter

f = mt.compile_file("filters/Distorts/fisheye.mm")
img = np.random.RandomState(0).rand(16, 20, 4).astype(np.float32)
out = f.render(img, device="cpu")
assert tuple(out.shape) == (16, 20, 4), out.shape
assert counter("launch.sample_image") == 0
m = mt.compile_file("filters/Render/mandelbrot.mm").render(width=20, height=16, device="cpu")
assert tuple(m.shape) == (16, 20, 4), m.shape
import mathmap_tpu_torch.parallel.bounds  # noqa: F401
import mathmap_tpu_torch.parallel.halo  # noqa: F401
import mathmap_tpu_torch.parallel.shard  # noqa: F401
import mathmap_tpu_torch.kernels.sample_tiled  # noqa: F401
mesh = mt.make_mesh(1, 2, 2, devices=["cpu"] * 4)
p = mt.compile_file("filters/Distorts/pond.mm")
img = np.random.RandomState(1).rand(64, 48, 4).astype(np.float32)
tiled = p.render_tiled(img, halo=(3, 3), mesh=mesh, params={"amplitude": 1.0})
sharded = p.render_sharded(img, mesh=mesh)
assert tuple(tiled.shape) == tuple(sharded.shape) == (64, 48, 4)
assert counter("launch.sample_tiled") == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mathmap_tpu", "PIL"))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_renders_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    """No module of the port, and neither GPU script beside it, imports jax
    or the JAX package, even lazily inside a function."""
    paths = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_profile.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "mathmap_tpu_torch")):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1 \
                        and words[1].split(".")[0] in ("jax", "jaxlib", "mathmap_tpu"):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def _imported_modules(tree: ast.AST, package: str) -> list:
    """Every module an import statement anywhere in `tree` names, relative
    imports resolved against `package`, with its line."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[:len(package.split(".")) + 1 - node.level]
            module = ".".join(base + ([node.module] if node.module else []))
            if node.level and not node.module:
                found += [(f"{module}.{a.name}", node.lineno) for a in node.names]
            else:
                found.append((module if node.level else node.module, node.lineno))
    return found


def test_the_kernel_layer_imports_nothing_above_it():
    """No module under mathmap_tpu_torch/kernels/ imports the evaluator's
    layers (runtime, lang, typesys), at module level or inside a function:
    the runtime calls the kernels, never the other way round."""
    kernels = os.path.join(REPO, "mathmap_tpu_torch", "kernels")
    above = tuple(f"mathmap_tpu_torch.{p}" for p in ("runtime", "lang", "typesys"))
    offenders, scanned = [], 0
    for name in sorted(os.listdir(kernels)):
        if not name.endswith(".py"):
            continue
        scanned += 1
        with open(os.path.join(kernels, name)) as fh:
            tree = ast.parse(fh.read())
        for module, line in _imported_modules(tree, "mathmap_tpu_torch.kernels"):
            if module in above or module.startswith(tuple(p + "." for p in above)):
                offenders.append(f"kernels/{name}:{line}: {module}")
    assert scanned >= 8 and not offenders, offenders


#: the reference's top-level names that the port once lacked
_SURFACE = ("read_image", "write_image", "to_float_rgba", "to_uint8", "Curve",
            "Gradient", "InputImage", "__version__")

_LAZY_NAMES = r"""
import sys
import mathmap_tpu_torch as mt
names = {names!r}
assert not any(m.startswith("mathmap_tpu_torch.") for m in sys.modules), sorted(sys.modules)
import mathmap_tpu_torch.generators.artifact  # noqa: F401
before = sorted(m for m in sys.modules if m.startswith("mathmap_tpu_torch."))
banned = [m for m in before if m.split(".")[1] in ("lang", "runtime", "api", "imgio")]
assert not banned, banned
for name in names:
    assert getattr(mt, name) is not None, name
print(sorted(m for m in sys.modules if m.startswith("mathmap_tpu_torch.")))
print("ok")
"""


def test_the_reference_surface_names_resolve_lazily():
    """Importing the package loads none of its modules, and the artifact
    loader alone no parser, runtime or image I/O; the eight names then
    resolve from their modules."""
    proc = subprocess.run([sys.executable, "-c", _LAZY_NAMES.format(names=_SURFACE)],
                          cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
    assert "mathmap_tpu_torch.imgio.images" in proc.stdout


def test_the_reference_surface_names_are_the_reference_objects_counterparts():
    import mathmap_tpu as mm

    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.imgio import images
    from mathmap_tpu_torch.runtime import value

    assert mt.__version__ == mm.__version__ == "0.1.0"
    for name in ("read_image", "write_image", "to_float_rgba", "to_uint8"):
        assert getattr(mt, name) is getattr(images, name)
    for name in ("Curve", "Gradient", "InputImage"):
        assert getattr(mt, name) is getattr(value, name)
    assert set(mt.__all__) == set(mm.__all__) | {"make_mesh"}
    assert len(mt.__all__) == len(set(mt.__all__))
    for name in mt.__all__:
        assert getattr(mt, name) is not None, name


def test_the_surface_names_work():
    import mathmap_tpu_torch as mt

    raw = np.random.RandomState(0).randint(0, 256, size=(6, 5, 3), dtype=np.uint8)
    rgba = mt.to_float_rgba(raw)
    assert rgba.shape == (6, 5, 4) and rgba.dtype == np.float32
    np.testing.assert_array_equal(mt.to_uint8(rgba)[..., :3], raw)
    assert mt.Curve.identity("cpu").lut.shape == (256,)
    assert mt.Gradient.default("cpu").lut.shape == (256, 4)
    f = mt.compile_source("filter c (image in, curve k) rgbaColor(k(red(in(xy))), 0, 0, 1) end")
    out = f.render(rgba, params={"k": mt.Curve.identity("cpu")}, interpret=True)
    np.testing.assert_array_equal(out[..., 0].numpy(), rgba[..., 0])
