"""The run's last line, and the numbers compared on standard error."""

from __future__ import annotations

import json
import sys


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def emit(line: dict, checks: dict, out=None, err=None) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and `line` with `checks` as its last key as the last
    line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        err.write(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}\n")
    err.flush()
    full = dict(line)
    full.pop("checks", None)
    full["checks"] = checks
    out.write(json.dumps(full) + "\n")
    out.flush()
