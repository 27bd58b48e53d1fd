"""Build the CUDA sources of this package at first use.

Every `*.cu` file under `mathmap_tpu_torch/csrc/` is compiled by nvcc for
Hopper (`sm_90a`) into ONE shared library with a plain C interface, loaded
with ctypes. The library lands in `mathmap_tpu_torch/kernels/build/`, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads from disk. Nothing here runs at import time: the first
CUDA launch calls `library()`, and a machine without a GPU never does.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
#: `-Xptxas=-v` only reports each kernel's registers and spills (Library.log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


@functools.cache
def library() -> Library:
    """Build (if needed) and load the kernel library; raises with nvcc's
    stderr when the build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    path = BUILD_DIR / f"libmm_kernels_{_digest(sources)}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: a concurrent process
        # never loads a half-written library
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
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
    return Library(ctypes.CDLL(str(path)), path, seconds, log)
