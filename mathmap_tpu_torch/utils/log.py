"""Structured logging + render statistics (a copy of
`mathmap_tpu/utils/log.py`): the CLI's `-v` and `--stats` report."""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field

logger = logging.getLogger("mathmap_tpu_torch")


def configure(verbose: bool = False) -> None:
    level = logging.DEBUG if verbose else logging.INFO
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.setLevel(level)
    if not logger.handlers:
        logger.addHandler(handler)


@dataclass
class RenderStats:
    """Per-phase timings for one render invocation (parse, render): the
    CLI's --stats line."""

    width: int = 0
    height: int = 0
    frames: int = 0
    parse_s: float = 0.0
    render_s: float = 0.0
    phases: dict = field(default_factory=dict)

    @property
    def mpix_per_s(self) -> float:
        total = self.frames * self.width * self.height
        return total / self.render_s / 1e6 if self.render_s else 0.0

    def to_json(self) -> str:
        return json.dumps({
            "width": self.width, "height": self.height, "frames": self.frames,
            "parse_s": round(self.parse_s, 4), "render_s": round(self.render_s, 4),
            "mpix_per_s": round(self.mpix_per_s, 2), **self.phases,
        })


class phase_timer:
    """with phase_timer(stats, 'decode'): ... — records elapsed seconds."""

    def __init__(self, stats: RenderStats, name: str):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stats.phases[self.name + "_s"] = round(time.perf_counter() - self.t0, 4)
        return False
