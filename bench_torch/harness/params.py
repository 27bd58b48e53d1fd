"""Filter params drawn from the seed, by the spec in a configuration file.

Each param of a filter entry's `params` is one of:

- {"uniform": [lo, hi]}: drawn anew for every call or job;
- {"per_job": [v0, v1, ...], "jitter": [j0, j1, ...]}: job k of a batch
  takes v_k (k modulo the list), plus a uniform draw in [-j_k, j_k] where
  `jitter` is given;
- {"value": v}: fixed.

Params a filter entry does not list keep the filter's defaults.
"""

from __future__ import annotations

import numpy as np


def draw(spec: dict, rng: np.random.Generator, job: int = 0) -> dict:
    out = {}
    for name, s in spec.items():
        if "uniform" in s:
            lo, hi = s["uniform"]
            v = rng.uniform(lo, hi)
        elif "per_job" in s:
            k = job % len(s["per_job"])
            v = s["per_job"][k]
            if "jitter" in s:
                v += rng.uniform(-s["jitter"][k], s["jitter"][k])
        elif "value" in s:
            v = s["value"]
        else:
            raise ValueError(f"param {name!r}: no distribution in {s}")
        out[name] = float(v)
    return out


def draw_t(rng: np.random.Generator) -> float:
    """An animation time in [0, 1)."""
    return float(rng.uniform(0.0, 1.0))
