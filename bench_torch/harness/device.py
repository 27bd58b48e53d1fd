"""What the run needs of the device, and what it says about it."""

from __future__ import annotations

import subprocess

import torch


class NoDevice(RuntimeError):
    """The cell asks for more CUDA devices than this machine has."""


def require_cuda(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the GPU and never the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, this machine has "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def power_limit_w() -> float | None:
    """The card's power limit in watts (nvidia-smi), or None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(dev: torch.device, chips: int) -> dict:
    """The result line's `device`: platform, kind, count, peak memory."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit_w": power_limit_w()}


def synchronizer(dev: torch.device):
    """The call that waits for the device's queued work (none on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
