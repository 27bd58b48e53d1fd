"""The comparison that decides `correct`: the program's answers against the
plain reference's, and the numbers it is judged by.

- `worst_abs`: the largest |answer - reference| over every value of every
  sampled answer, in output units (a uint8 answer is divided by 255);
- `off_share`: the largest share, over the sampled answers, of values that
  differ by more than OFF_ABOVE, about one 8-bit level;
- `missing`: sampled answers that never came or could not be read.

A cell's file (`workloads/<cell>.json`) names the numbers it is held to
and their limits; every number is printed, each compared one beside its
limit.
"""

from __future__ import annotations

import math

import torch

#: a difference that shows: above one 8-bit level (1/255 = 0.00392)
OFF_ABOVE = 0.004
#: what a number that is not finite (a NaN answer) is reported as
NOT_FINITE = 1e9


def as_unit(img: torch.Tensor) -> torch.Tensor:
    """An answer in [0, 1] float64: uint8 divided by 255."""
    if img.dtype == torch.uint8:
        return img.to(torch.float64) / 255.0
    return img.to(torch.float64)


class Comparison:
    def __init__(self):
        self.worst_abs = 0.0
        self.off_share = 0.0
        self.answers = 0
        self.missing = 0

    def add(self, got: torch.Tensor | None, want: torch.Tensor) -> None:
        """One sampled answer (None: it never came) against its reference."""
        if got is None or tuple(got.shape) != tuple(want.shape):
            self.missing += 1
            return
        d = (as_unit(got.to(want.device)) - as_unit(want)).abs()
        d = torch.nan_to_num(d, nan=math.inf)
        self.worst_abs = max(self.worst_abs, float(d.max()))
        self.off_share = max(self.off_share, float((d > OFF_ABOVE).double().mean()))
        self.answers += 1

    def numbers(self) -> dict:
        worst = self.worst_abs if math.isfinite(self.worst_abs) else NOT_FINITE
        return {"worst_abs": worst, "off_share": self.off_share, "missing": float(self.missing)}


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, checks): every number named in `limits` at or under
    its limit, and no answer missing. `checks` maps each compared number
    to {"value", "limit"}."""
    limits = dict(limits)
    limits.setdefault("missing", 0.0)
    checks = {name: {"value": numbers[name], "limit": float(limit)}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
