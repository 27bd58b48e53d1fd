"""Deployment self-test: a fast acceptance sweep on the ACTIVE device (the
port of `mathmap_tpu/selftest.py`).

`python -m mathmap_tpu_torch --selftest` renders the reference's ten
path-exercising configs (pointwise math, warp sampling at each
interpolation/edge class, LUT application, noise, a while loop, the static
unroll, animated frame indexing, supersampling) on the device the front
ends use (`api.platform_device`: the GPU, or the CPU under
MMTPU_PLATFORM=cpu) and holds each against the same render on the CPU,
the kernels' plain versions. So on the card it checks kernels B1 (origVal),
B2 (the gradient) and B3 (the loop) and the eager ops against the CPU
route, which the tests hold against the NumPy oracle. Tolerance
rtol=1e-4, atol=1e-5; the while-loop config keeps the reference's fraction
rule (under 1% of values off by more than 0.02: one iteration more or less
on a chaotic escape boundary moves a whole gradient step). Returns the
number of failures.
"""

from __future__ import annotations

import time

RTOL, ATOL = 1e-4, 1e-5


def _configs():
    """(name, source, options_kw, frame) — sized for a ~128px canvas."""
    return [
        ("pointwise", "grayColor(clamp(sin(x / 9) * cos(y / 7) * 0.5 + 0.5,"
                      " 0, 1))", {}, 0.0),
        ("warp/bilinear/wrap",
         "origVal(xy + xy:[4 * sin(y / 11), 3 * cos(x / 13)])",
         dict(interpolation="bilinear", edge_x="wrap", edge_y="wrap"), 0.0),
        ("warp/bicubic/reflect",
         "origVal(xy * 0.8 + xy:[2, -1])",
         dict(interpolation="bicubic", edge_x="reflect", edge_y="reflect"),
         0.0),
        ("warp/nearest/color",
         "origVal(toXY(ra:[r * 1.2, a + 0.3]))",
         dict(interpolation="nearest", edge_color=(1.0, 0.0, 0.0, 1.0)),
         0.0),
        ("lut/gradient",
         "filter f (image in, gradient g) g(clamp(r / R, 0, 1)) end",
         {}, 0.0),
        ("noise", "grayColor(clamp(noise([x / 17, y / 17, 0.4]) * 0.5 + 0.5,"
                  " 0, 1))", {}, 0.0),
        ("while-loop",
         "i = 0; z = ri:[x / 64, y / 64]; c = z;"
         " while abs(z) < 2 && i < 12 do z = z * z + c; i = i + 1 end;"
         " grayColor(i / 12)", {}, 0.0),
        ("static-unroll",
         "i = 0; s = 0; while i < 5 do s = s + sin(x / 9 + i); i = i + 1 "
         "end; grayColor(clamp(s / 5 + 0.5, 0, 1))", {}, 0.0),
        ("animated-frame", "origValXY(x, y, 1)",
         dict(interpolation="nearest"), 0.0),
        ("supersample", "origVal(xy + xy:[2 * sin(y / 9), 0])",
         dict(supersample=2), 0.0),
    ]


def selftest_inputs(size: int):
    """The sweep's seeded (size, size, 4) image and its 2-frame stack."""
    import numpy as np

    rng = np.random.RandomState(7)
    img = rng.rand(size, size, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img, np.stack([img, img[::-1]])


def render_config(name, src, kw, frame, size: int, device):
    """One config's render on `device` -> (H, W, 4) float32 numpy."""
    from . import RenderOptions, compile_source

    img, stack = selftest_inputs(size)
    f = compile_source(src)
    inp = stack if name == "animated-frame" else img
    args = [inp] if f.image_params else []
    out = f.render(*args, width=size, height=size, t=0.25, frame=frame,
                   options=RenderOptions(**kw), device=device)
    return out.cpu().numpy()


def compare(name, got, want) -> tuple:
    """(ok, detail) of a config's render against its CPU render."""
    import numpy as np

    diff = np.abs(got - want)
    if name == "while-loop":
        frac = float((diff > 0.02).mean())
        return frac < 0.01, f"frac>{0.02}={frac:.4f}"
    excess = float((diff - RTOL * np.abs(want)).max())
    return excess <= ATOL, f"max={float(diff.max()):.2e} rtol={RTOL:g} atol={ATOL:g}"


def run_selftest(size: int = 128, verbose: bool = False, device=None) -> int:
    """Render every config on `device` (default: the front ends' device)
    and on the CPU; print a PASS/FAIL line per config and return the
    number of failures."""
    import torch

    from .api import platform_device, resolve_device

    dev = platform_device() if device is None else resolve_device(device)
    label = (f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else str(dev))
    failures = 0
    print(f"mathmap_tpu_torch selftest: device={label} size={size}")
    for name, src, kw, frame in _configs():
        t0 = time.perf_counter()
        try:
            got = render_config(name, src, kw, frame, size, dev)
            want = render_config(name, src, kw, frame, size, "cpu")
            ok, detail = compare(name, got, want)
            dt = time.perf_counter() - t0
            status = "OK" if ok else "FAIL"
            print(f"  {name:24s} {status:4s} {detail}"
                  + (f"  [{dt:.1f}s]" if verbose else ""))
            failures += 0 if ok else 1
        except Exception as e:  # noqa: BLE001 — a crash IS a failure
            print(f"  {name:24s} FAIL {type(e).__name__}: {e}")
            failures += 1
    print(f"selftest: {'OK' if not failures else 'FAILED'} "
          f"({len(_configs()) - failures}/{len(_configs())} passed)")
    return failures
