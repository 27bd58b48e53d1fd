"""Render options — the same fields, defaults and validation as the JAX
package's `mathmap_tpu.runtime.options.RenderOptions`, field for field, so
one set of options drives both packages (convert.options_from_reference).

Fields fall in two groups on this card:

- implemented: interpolation, edge_x, edge_y, edge_color, supersample
  and supersample_scheme (the s×s grid, or the shared corner grid plus
  the pixel centres), output_dtype, region (a sub-rectangle evaluated
  with the full canvas's coordinates), static_params, seed (rand()'s
  draws), periodic (the t of an animation's frames), and the loop options
  max_loop_iters, while_unroll, while_static_unroll and pallas_while,
  which maps onto this package's while-loop kernel switch (kernel B3):
  'off' runs every loop as the masked eager loop, 'auto' runs every
  eligible loop on a CUDA device through its generated kernel after the
  static-trip-count unroll has had its chance (at any size: there is no
  TPU-style pixel threshold), and 'on' takes the kernel even over the
  static unroll;
- accepted and validated, but steering only TPU machinery, so they have
  no effect here: sampler, pallas_tiers, pallas_per_tile,
  pallas_precision, sweep_unroll.
"""

from __future__ import annotations

from dataclasses import dataclass

INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_BEHAVIORS = ("color", "wrap", "reflect")


@dataclass(frozen=True)
class RenderOptions:
    interpolation: str = "bilinear"
    edge_x: str = "color"
    edge_y: str = "color"
    #: RGBA used by the 'color' edge behavior (default transparent).
    edge_color: tuple = (0.0, 0.0, 0.0, 0.0)
    #: supersampling antialiasing: 1 = off, s = s×s subpixel grid.
    supersample: int = 1
    #: 'grid' (s×s subpixels) or 'corners' (one (h+1, w+1) corner grid plus
    #: the centres, five samples a pixel; used when supersample > 1).
    supersample_scheme: str = "grid"
    #: 'float32': (H, W, 4) in [0, 1]; 'uint8': packed on the device with
    #: the round-to-nearest 8-bit rule (kernels/finish_rgba.py::pack_uint8).
    output_dtype: str = "float32"
    #: (x, y, w, h) sub-rectangle render: only the (h, w) grid is evaluated,
    #: while x/y/W/H/R and input sampling keep the full canvas.
    region: tuple | None = None
    #: per-pixel `while` trip-count cap.
    max_loop_iters: int = 10000
    #: while-loop kernel switch: 'auto', 'on' (over the static unroll) or
    #: 'off' (the masked eager loop); see the module docstring.
    pallas_while: str = "auto"
    #: masked eager-loop steps per convergence check.
    while_unroll: int = 4
    #: static-trip-count while unroll budget (steps).
    while_static_unroll: int = 64
    #: animation time convention: frame i of N is at t = i/N when periodic,
    #: else i/(N-1) (render_animation, render_frames, render_sharded).
    periodic: bool = True
    #: rand()'s seed: every draw hashes it (ops/rand.py).
    seed: int = 0
    #: param names whose values are trace-time constants: their values
    #: carry a constant mirror, like the reference's baked params.
    static_params: tuple = ()
    #: TPU sampler backend switch: no effect on this card, where a CUDA
    #: tensor always goes through the CUDA sampler (kernels/sample_image).
    sampler: str = "auto"
    #: TPU sampler tier ladder: no effect on this card.
    pallas_tiers: tuple = (
        (8, 256, 32, 512, 128),
        (8, 64, 32, 256, 0),
        (8, 64, 64, 128, 0),
        (8, 64, 64, 256, 0),
        (8, 64, 128, 128, 0),
        (8, 128, 320, 384, 256),
        (8, 64, 512, 512, 160),
    )
    #: TPU per-tile tier selection: no effect on this card.
    pallas_per_tile: str = "auto"
    #: TPU frame-sweep unroll factor: no effect on this card.
    sweep_unroll: object = "auto"
    #: TPU MXU precision of the sampler: no effect on this card, whose
    #: sampler computes in fp32.
    pallas_precision: str = "bf16"

    def __post_init__(self):
        if self.interpolation not in INTERPOLATIONS:
            raise ValueError(f"interpolation must be one of {INTERPOLATIONS}")
        if self.edge_x not in EDGE_BEHAVIORS or self.edge_y not in EDGE_BEHAVIORS:
            raise ValueError(f"edge behaviors must be one of {EDGE_BEHAVIORS}")
        if self.supersample < 1:
            raise ValueError("supersample must be >= 1")
        if self.supersample_scheme not in ("grid", "corners"):
            raise ValueError("supersample_scheme must be 'grid' or 'corners'")
        if self.output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be 'float32' or 'uint8'")
        if self.while_unroll < 1:
            raise ValueError("while_unroll must be >= 1")
        ec = tuple(float(c) for c in self.edge_color)
        if len(ec) == 3:
            ec = ec + (1.0,)  # RGB convenience: opaque alpha
        if len(ec) != 4:
            raise ValueError(
                f"edge_color needs 3 or 4 components, got {len(ec)}")
        object.__setattr__(self, "edge_color", ec)
        if self.region is not None:
            reg = tuple(int(v) for v in self.region)
            if len(reg) != 4:
                raise ValueError("region must be (x, y, w, h)")
            if reg[2] < 1 or reg[3] < 1:
                raise ValueError("region w/h must be >= 1")
            if reg[0] < 0 or reg[1] < 0:
                raise ValueError("region x/y must be >= 0")
            object.__setattr__(self, "region", reg)
        if self.sampler not in ("auto", "pallas", "gather"):
            raise ValueError("sampler must be 'auto', 'pallas' or 'gather'")
        if self.sweep_unroll != "auto" and (
                not isinstance(self.sweep_unroll, int)
                or self.sweep_unroll < 1):
            raise ValueError("sweep_unroll must be 'auto' or an int >= 1")
        for tier in self.pallas_tiers:
            if len(tier) != 5:
                raise ValueError(
                    "each pallas tier is (tile_h, tile_w, win_h, win_w, subw)")
            th, tw, wh, ww, sw = tier
            if th != 8 or tw % 64 or 256 % tw:
                raise ValueError(
                    "pallas tier tiles must be (8, divisor-of-256 mult-of-64)")
            if wh % 32 or ww % 16:
                raise ValueError(
                    "pallas tier windows must be (mult of 32, mult of 16)")
            if sw < 0 or sw % 8:
                raise ValueError(
                    "tier subw must be a non-negative multiple of 8 (0 = off)")
            if tw == 64 and sw and sw % 32:
                raise ValueError(
                    "sub-chunk tier (tile_w 64) subw must be a multiple of 32")
        if self.pallas_while not in ("auto", "on", "off"):
            raise ValueError("pallas_while must be 'auto', 'on' or 'off'")
        if not isinstance(self.static_params, tuple) or not all(
                isinstance(n, str) for n in self.static_params):
            raise ValueError("static_params must be a tuple of param names")
        if self.pallas_per_tile not in ("auto", "on", "off"):
            raise ValueError("pallas_per_tile must be 'auto', 'on' or 'off'")
        if self.pallas_precision not in ("bf16", "f32"):
            raise ValueError("pallas_precision must be 'bf16' or 'f32'")
