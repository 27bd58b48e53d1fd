"""The PyTorch port imports and renders with JAX blocked, and never loads the
JAX package (the card's machine has neither jax nor Pillow): the unsharded
renders, and the tiled and sharded renders of mathmap_tpu_torch.parallel on
a CPU mesh."""

import os
import subprocess
import sys

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
import mathmap_tpu_torch.kernels.sample_image as K

f = mt.compile_file("filters/Distorts/fisheye.mm")
img = np.random.RandomState(0).rand(16, 20, 4).astype(np.float32)
out = f.render(img, device="cpu")
assert tuple(out.shape) == (16, 20, 4), out.shape
assert K.sample_image.launches == 0
m = mt.compile_file("filters/Render/mandelbrot.mm").render(width=20, height=16, device="cpu")
assert tuple(m.shape) == (16, 20, 4), m.shape
import mathmap_tpu_torch.parallel.bounds  # noqa: F401
import mathmap_tpu_torch.parallel.halo  # noqa: F401
import mathmap_tpu_torch.parallel.shard  # noqa: F401
import mathmap_tpu_torch.kernels.sample_tiled as B4
mesh = mt.make_mesh(1, 2, 2, devices=["cpu"] * 4)
p = mt.compile_file("filters/Distorts/pond.mm")
img = np.random.RandomState(1).rand(64, 48, 4).astype(np.float32)
tiled = p.render_tiled(img, halo=(3, 3), mesh=mesh, params={"amplitude": 1.0})
sharded = p.render_sharded(img, mesh=mesh)
assert tuple(tiled.shape) == tuple(sharded.shape) == (64, 48, 4)
assert B4.sample_tiled.launches == 0
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
