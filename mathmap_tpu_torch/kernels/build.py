"""Build the CUDA sources of this package at first use.

Every `*.cu` file under `mathmap_tpu_torch/csrc/` (with the `*.cuh` headers
they share) is compiled by nvcc for Hopper (`sm_90a`) into ONE shared
library with a plain C interface, loaded with ctypes (`library()`). Each
generated source (a while loop's kernel, kernels/while_loop.py) is
compiled into a library of its own (`generated_library()`), with
`--fmad=false` so nvcc keeps every multiply and add separately rounded, as
the eager torch ops are. Libraries land in
`mathmap_tpu_torch/kernels/build/`, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads from disk;
each is loaded once per process. Nothing here runs at import time: the
first CUDA launch builds, and a machine without a GPU never does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ..utils.trace import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
#: `-Xptxas=-v` only reports each kernel's registers and spills (Library.log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: generated kernels: no FMA contraction (escape-time counts are chaotic, so
#: a loop body must round like the eager torch ops, one op at a time), and
#: the precise libm and IEEE division/sqrt (nvcc's defaults, no fast math)
GENERATED_FLAGS = NVCC_FLAGS + ("--fmad=false",)


@dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: Path
    #: nvcc's wall time in this process; 0.0 when the library was on disk
    build_seconds: float
    #: nvcc's stderr (ptxas register/spill report); empty when not built
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels of mathmap_tpu_torch cannot be built")
    return str(path)


def _digest(sources) -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def _build(path: Path, flags, sources) -> Library:
    """Load `path`, running nvcc on `sources` first when it is not on disk;
    raises with nvcc's stderr when the build fails. A `mm.build` span; each
    nvcc run adds 1 to the counter `build.nvcc`."""
    with span("mm.build"):
        return _build_and_load(path, flags, sources)


def _build_and_load(path: Path, flags, sources) -> Library:
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: a concurrent process
        # never loads a half-written library
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
        log = proc.stderr
        count("build.nvcc")
    return Library(ctypes.CDLL(str(path)), path, seconds, log)


@functools.cache
def library() -> Library:
    """Build (if needed) and load the library of csrc/*.cu; the headers
    they include (csrc/*.cuh) are part of its name."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = _digest(sources + sorted(CSRC.glob("*.cuh")))
    return _build(BUILD_DIR / f"libmm_kernels_{digest}.so", NVCC_FLAGS, sources)


def generated_paths(source: str) -> tuple:
    """(source file, library file) of one generated CUDA source, named by a
    hash of the source and GENERATED_FLAGS."""
    h = hashlib.sha256(source.encode())
    for flag in GENERATED_FLAGS:
        h.update(b"\0" + flag.encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"mm_gen_{digest}.cu", BUILD_DIR / f"libmm_gen_{digest}.so"


@functools.cache
def generated_library(source: str) -> Library:
    """Build (if needed) and load the library of one generated CUDA source
    (generated_paths)."""
    src, lib = generated_paths(source)
    if not src.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = src.with_name(f"{src.stem}.{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, src)
    return _build(lib, GENERATED_FLAGS, [src])


def error_string(err: int) -> str:
    """cudaGetErrorString of a launcher's return code."""
    fn = library().cdll.mm_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()
