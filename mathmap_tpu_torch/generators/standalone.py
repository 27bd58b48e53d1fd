"""Code generators: export a filter as a runnable script or as the text of
its exported program (the port of `mathmap_tpu/generators/standalone.py`).

  - `export_python(filter, path)`: a self-contained Python script embedding
    the .mm source and a minimal CLI (it needs mathmap_tpu_torch at run
    time, and renders on the GPU, or on the CPU under MMTPU_PLATFORM=cpu).
  - `export_program_text(filter, width, height)`: the filter's frame
    program as `torch.export` traces it, as text: the ATen ops and the
    `mathmap::` kernel ops with their (H, W) shapes. The reference's
    counterpart, `export_stablehlo`, prints StableHLO, which a PyTorch
    program has no form of.
"""

from __future__ import annotations

import json

_TEMPLATE = '''#!/usr/bin/env python
"""Standalone MathMap filter: {name} (generated by mathmap_tpu_torch)."""

import argparse

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.api import platform_device
from mathmap_tpu_torch.imgio.images import read_image, write_image

SOURCE = {source!r}
DEFAULT_PARAMS = {params}


def main():
    ap = argparse.ArgumentParser(description="render the {name!r} filter")
    ap.add_argument("images", nargs="*", help="input image(s)..., output image")
    ap.add_argument("--size", default=None)
    ap.add_argument("--t", type=float, default=0.0)
    ap.add_argument("--param", action="append", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    *inputs, out_path = args.images
    params = dict(DEFAULT_PARAMS)
    for item in args.param:
        k, v = item.split("=", 1)
        params[k] = float(v)
    width = height = None
    if args.size:
        width, height = (int(v) for v in args.size.lower().split("x"))
    filt = mt.compile(SOURCE, main={name!r})
    out = filt.render(*[read_image(p) for p in inputs], width=width, height=height,
                      t=args.t, params=params, device=platform_device())
    write_image(out_path, out)


if __name__ == "__main__":
    main()
'''


def export_python(filt, path: str, params: dict | None = None) -> None:
    """Write a runnable Python script embedding the filter."""
    defaults = {}
    for p in filt.params:
        if p.kind in ("int", "float", "bool") and p.default is not None:
            defaults[p.name] = p.default
    defaults.update(params or {})
    script = _TEMPLATE.format(name=filt.name, source=filt.source,
                              params=json.dumps(defaults))
    with open(path, "w") as f:
        f.write(script)


def export_program_text(filt, width: int, height: int, options=None, device="cuda") -> str:
    """The filter's frame program at (width, height), traced on `device`
    by torch.export (params at their defaults), as text."""
    from ..api import resolve_device
    from ..runtime.options import RenderOptions
    from .artifact import _export

    program, _spec = _export(filt, int(width), int(height), options or RenderOptions(),
                             resolve_device(device), {})
    return str(program)
