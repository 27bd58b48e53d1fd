#!/usr/bin/env python3
"""Where a render's time goes on one NVIDIA GPU, and how far card and CPU
renders of the PyTorch port (mathmap_tpu_torch) drift apart.

    python3 chip_profile.py              # from the root of a checkout, on a GPU host
    python3 chip_profile.py kernels DIR  # part 3 alone, on the package in DIR
    python3 chip_profile.py renders DIR  # part 4 alone, on the package in DIR
    python3 chip_profile.py dispatch     # part 5 alone

Five parts, each printing one line per case (the first two by default):

1. profile: fisheye, twirl and pond at their default params, u8 input of
   1920x1080 and 3840x2160 already on the device, mandelbrot at its
   default params at both sizes, through the generated loop kernel and
   (pallas_while="off") through the masked eager loop, turbulence and
   voronoi (noise), static_tv (rand) and rand_walk (rand in a B3 loop) at
   3840x2160, and pond through
   render_tiled on a (1,4,1) mesh of the card (and at 4K a (1,2,2) one)
   and through render_sharded on (1,4,1); at 4K also render_tiled on the
   default mesh, every visible card on the rows (on a host of several
   cards, the kernel and busy times are sums over the cards); BASELINE
   config 4's frames (ripple at 1080p, supersample=2 as
   benchmarks/run_configs.py renders "4x AA", through render_animation, 8
   frames a call) and chip_smoke's param batch (8 mandelbrot jobs at 4K
   through render_batch), per frame or job; the library slice at 4K:
   quat_julia (a vector loop through B3), sharpen (gaussian_blur, then B1
   twice), gamma_spiral (complex gamma) and the composition dream_pond
   (pond, chromatic_aberration, bleach_bypass), each compiled by
   default_db(); the front-end slice: ripple at 1080p under
   supersample=2 with supersample_scheme='corners', and twirl at 4K over
   chip_smoke's REGION (an unaligned 28% selection); the deployment
   slice: twirl and mandelbrot at 4K through exported artifacts
   (generators/artifact.py, exported on the card at their defaults). The
   median of 20 fenced renders (5 calls of a sweep or batch, as
   chip_smoke.py times them), then torch.profiler over 5 renders (calls):
   device kernels per render, device busy ms per render and its share of
   the median, split into the channel stack (the cat kernel of
   render_frame's torch.stack, and of the tiled renders' halo exchange and
   tile assembly), the kernels B1 (sampler), B2 (LUT), B3 (generated while
   loop) and B4 (tiled sampler) and all other torch kernels, plus the
   host-device copies and cudaStreamSynchronize calls per render.
2. coords: each filter at 1920x1080 rendered on the card and on the CPU
   (the plain sampler). The largest difference of the world coordinates the
   two hand to the sampler (in pixels), and of the outputs on three seeded
   images: noise, a smooth image, and the same smooth image faded to the
   edge color at its border (chip_smoke.py's comparison image).
3. kernels: kernel B1 alone in its six 3840x2160 cases (nearest, bilinear,
   bicubic on u8 and f32) on the smooth warp, and on the coordinate fields
   that fisheye, twirl and pond hand it at 3840x2160 (u8, each
   interpolation), with its bound and grid_sample yardstick, and kernel B4
   on pond's interior tile (chip_smoke.py's timings, without B1's plain
   version), for the package in DIR (default: this checkout). Checkouts are
   compared on one card by running it on each in turns in one call:
   parent, change, change, parent.
4. renders: fenced medians of 20 renders of fisheye, twirl and pond (u8
   in) and default mandelbrot at 1920x1080 and 3840x2160 through the
   package in DIR, compared between checkouts like part 3.
5. dispatch: the host microseconds a call of B1, B2 and B3 through their
   torch.library ops (the route every render takes) against their CUDA
   implementations called directly, at 1920x1080.

Every line carries the card's name and power limit. It imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from chip_smoke import (ANIMATION_SUPERSAMPLE, BATCH_JOBS, FILTERS, RAND_WALK, REGION, ROOT,
                        SIZES, batch_params, card_line, fenced_median_ms, phase_tiled_timings,
                        seeded_image, smooth_image, time_b1, time_b1_fields)

PROFILED_RENDERS = 5
#: the library slice's profiled renders (4K)
LIBRARY_PROFILED = ("quat_julia", "sharpen", "gamma_spiral", "dream_pond")
#: frames a profiled render_animation call renders, and the timed calls of
#: a multi-frame case
ANIMATION_CALL = 8
TIMED_CALLS = 5


#: kernel-name fragment -> class
KERNEL_CLASSES = (("sample_image_kernel", "B1"), ("apply_lut_kernel", "B2"),
                  ("while_loop_kernel", "B3"), ("sample_tiled_kernel", "B4"),
                  ("CatArrayBatchedCopy", "stack"))


def profile_render(render, per: int = 1):
    """Per-render device time by kernel class, from torch.profiler;
    `render()` renders `per` frames (or batch jobs), and the numbers are
    per frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_RENDERS):
            render()
        torch.cuda.synchronize()
    us = {"stack": 0.0, "B1": 0.0, "B2": 0.0, "B3": 0.0, "B4": 0.0, "other": 0.0,
          "copy": 0.0}
    kernels = copies = syncs = 0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
                us["copy"] += dur
                continue
            kernels += 1
            cls = next((c for frag, c in KERNEL_CLASSES if frag in e.name), "other")
            us[cls] += dur
        elif e.name == "cudaStreamSynchronize":
            syncs += 1
    n = PROFILED_RENDERS * per
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return ({k: v / n / 1e3 for k, v in us.items()}, kernels / n, copies / n,
            syncs / n, [(k[:70], v / n / 1e3) for k, v in top])


def exported_artifacts(twirl, mandelbrot, w: int, h: int, dev) -> dict:
    """twirl and mandelbrot at their defaults exported on `dev` at (w, h)
    and loaded back (generators/artifact.py)."""
    import tempfile

    from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact

    arts = {}
    with tempfile.TemporaryDirectory() as d:
        for name, f in (("twirl", twirl), ("mandelbrot", mandelbrot)):
            path = str(Path(d) / f"{name}.mmxa")
            export_artifact(f, path, w, h, device=dev)
            arts[name] = load_artifact(path)
    return arts


def part_renders(mt, dev, card):
    """Fenced medians of 20 renders through the package `mt`: the
    distortion suite (u8 in) and default mandelbrot at 1920x1080 and
    3840x2160, the host-bound and the device-bound sizes."""
    print(f"renders of {Path(mt.__file__).parent}")
    filters = {n: mt.compile_file(str(ROOT / "filters" / "Distorts" / f"{n}.mm"))
               for n in FILTERS}
    mandelbrot = mt.compile_file(str(ROOT / "filters" / "Render" / "mandelbrot.mm"))
    for (w, h) in SIZES:
        img = torch.from_numpy(seeded_image(w, h, seed=4)[1]).to(dev)
        cases = [(n, lambda f=f: f.render(img, device=dev)) for n, f in filters.items()]
        cases.append(("mandelbrot", lambda: mandelbrot.render(width=w, height=h, device=dev)))
        for name, render in cases:
            print(f"render {name} {w}x{h}: median {fenced_median_ms(render):.3f} ms [{card}]")


DISPATCH_CALLS = 500


def part_dispatch(mt, dev, card):
    """Host microseconds a call of each kernel through its torch.library
    op (the route every render takes) against its CUDA implementation
    called directly (the launch the op dispatches to), at 1920x1080: the
    binding's own host cost. No sync inside a timed run, so the host times
    its enqueue; the card drains the queue between runs."""
    import time

    from mathmap_tpu_torch.kernels import apply_lut as L
    from mathmap_tpu_torch.kernels import sample_image as K
    from mathmap_tpu_torch.kernels import while_loop as WL
    from mathmap_tpu_torch.runtime import loops, tracer

    w, h = SIZES[0]
    img = torch.from_numpy(seeded_image(w, h, seed=4)[1]).to(dev)
    x, y = (torch.rand((h, w), device=dev) * 100 for _ in range(2))
    pos = torch.rand((h, w), device=dev)
    lut = torch.rand((256, 4), device=dev)
    mand = mt.compile_file(str(ROOT / "filters" / "Render" / "mandelbrot.mm"))
    calls = []
    orig = tracer.loop_kernel
    tracer.loop_kernel = lambda *a: calls.append(a) or orig(*a)
    try:
        mand.render(width=w, height=h, device=dev)
    finally:
        tracer.loop_kernel = orig
    loop, flat0, mask0, max_iters = calls[0]
    prog, text = loops._prepare(loop, len(flat0))
    values = {("carry", k): a for k, a in enumerate(flat0)}
    values.update({("x",): loop.x, ("y",): loop.y})
    values.update({("dep", n, j): a for n, tv in loop.deps for j, a in enumerate(tv.arrays)})
    grids = [values[k] for k in prog.grid_inputs]
    scalars = torch.zeros(0)
    loop_args = (text, grids, mask0, scalars, max_iters, loop.unroll, 0, 0, w,
                 loop.rand_salt, loop.it_base)
    edge = [0.0, 0.0, 0.0, 0.0]
    cases = (
        ("B1 sample_image", lambda: K.sample_image(img, x, y, "bilinear", "color", "color",
                                                   edge),
         lambda: K._sample_image_cuda(img, x, y, "bilinear", "color", "color", edge)),
        ("B2 apply_lut", lambda: L.apply_lut(lut, pos), lambda: L._apply_lut_cuda(lut, pos)),
        ("B3 while_loop", lambda: loops.while_loop(loop, flat0, mask0, max_iters),
         lambda: WL._while_loop_cuda(*loop_args)),
    )

    def host_us(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    for name, via_op, direct in cases:
        n = DISPATCH_CALLS if name != "B3 while_loop" else DISPATCH_CALLS // 5
        runs = [host_us(via_op, n), host_us(direct, n), host_us(direct, n), host_us(via_op, n)]
        op_us, direct_us = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        print(f"dispatch {name} {w}x{h}: {op_us:.1f} us a call through the op and its "
              f"wrapper, {direct_us:.1f} us through the CUDA implementation directly "
              f"(+{op_us - direct_us:.1f} us; runs op, direct, direct, op: "
              f"{', '.join(f'{r:.1f}' for r in runs)}) [{card}]")


def part_profile(mt, filters, mandelbrot, stochastic, library, eager_loop, dev, card):
    """`eager_loop`: RenderOptions that run mandelbrot's loop as the masked
    eager loop (pallas_while="off"), for the syncs the kernel removes;
    `library`: name -> default_db() Filter of the library slice's 4K rows;
    `stochastic`: turbulence (four noise calls), voronoi (18), static_tv
    (one rand() draw) and rand_walk (a loop that draws, through B3),
    profiled at 4K. The
    tiled renders (pond through render_tiled on (1,4,1) and, at 4K, (1,2,2)
    meshes of the first card and on the default mesh of every card) and
    the sharded one (pond through render_sharded on (1,4,1)) run their
    tiles one after another from one process."""
    def mesh(*shape):
        return mt.make_mesh(*shape, devices=[dev] * (shape[1] * shape[2]))

    aa = mt.RenderOptions(supersample=ANIMATION_SUPERSAMPLE)
    corners = mt.RenderOptions(supersample=2, supersample_scheme="corners")
    batch = batch_params()

    for (w, h) in SIZES:
        _, u8 = seeded_image(w, h, seed=4)
        img = torch.from_numpy(u8).to(dev)
        cases = [(name, lambda f=filters[name]: f.render(img, device=dev))
                 for name in FILTERS]
        if (w, h) == SIZES[0]:
            cases.append(("ripple corners supersample=2", lambda: filters["ripple"].render(
                img, options=corners, device=dev)))
            cases.append((f"ripple animation supersample={ANIMATION_SUPERSAMPLE}, per frame "
                          f"of {ANIMATION_CALL}",
                          lambda: filters["ripple"].render_animation(
                              img, num_frames=ANIMATION_CALL, options=aa, device=dev),
                          ANIMATION_CALL))
        cases.append(("mandelbrot", lambda: mandelbrot.render(width=w, height=h,
                                                              device=dev)))
        cases.append(("mandelbrot, eager loop", lambda: mandelbrot.render(
            width=w, height=h, options=eager_loop, device=dev)))
        pond = filters["pond"]
        cases.append(("pond tiled (1,4,1)", lambda: pond.render_tiled(img, mesh=mesh(1, 4, 1))))
        if (w, h) == SIZES[1]:
            cases.append((f"mandelbrot batch, per job of {BATCH_JOBS}",
                          lambda: mandelbrot.render_batch(width=w, height=h, params=batch,
                                                          frames=[0.0] * BATCH_JOBS,
                                                          device=dev), BATCH_JOBS))
            cases += [(name, lambda f=stochastic[name]: f.render(width=w, height=h, device=dev))
                      for name in ("turbulence", "voronoi", "rand_walk")]
            cases.append(("static_tv", lambda: stochastic["static_tv"].render(img, device=dev)))
            cases += [(name, lambda f=f: f.render(*[img] * len(f.image_params), width=w,
                                                  height=h, t=0.3, device=dev))
                      for name, f in library.items()]
            cases.append((f"twirl region {REGION}", lambda: filters["twirl"].render(
                img, options=mt.RenderOptions(region=REGION), device=dev)))
            arts = exported_artifacts(filters["twirl"], mandelbrot, w, h, dev)
            fimg = img.to(torch.float32) / 255.0
            cases.append(("twirl artifact", lambda: arts["twirl"].render(fimg)))
            cases.append(("mandelbrot artifact", lambda: arts["mandelbrot"].render()))
            cases.append(("pond tiled (1,2,2)",
                          lambda: pond.render_tiled(img, mesh=mesh(1, 2, 2))))
            cases.append(("pond sharded (1,4,1)",
                          lambda: pond.render_sharded(img, mesh=mesh(1, 4, 1))))
            cards = torch.cuda.device_count()
            cases.append((f"pond tiled, make_mesh() over {cards} card(s)",
                          lambda: pond.render_tiled(img, mesh=mt.make_mesh())))
        for name, render, *per in cases:
            per = per[0] if per else 1
            median = fenced_median_ms(render, n=TIMED_CALLS if per > 1 else 20) / per
            ms, kernels, copies, syncs, top = profile_render(render, per)
            busy = sum(ms.values())
            print(f"profile {name} {w}x{h}: median {median:.3f} ms/frame, "
                  f"{kernels:g} kernels, device busy {busy:.4f} ms "
                  f"({100 * busy / median:.1f}% of the median): stack "
                  f"{ms['stack']:.4f}, other torch {ms['other']:.4f}, B1 "
                  f"{ms['B1']:.4f}, B2 {ms['B2']:.4f}, B3 {ms['B3']:.4f}, B4 "
                  f"{ms['B4']:.4f}, copies {ms['copy']:.4f} ms ({copies:g}); "
                  f"{syncs:g} cudaStreamSynchronize per render [{card}]")
            for kname, kms in top:
                print(f"  top kernel {kms:.4f} ms/render: {kname}")


def sampler_coordinates(f, img, device):
    """Render once; the output and the (x, y) grids handed to the sampler."""
    from mathmap_tpu_torch.runtime import sampling

    seen = []
    kernel = sampling.sample_kernel

    def recording(pixels, x, y, *args):
        seen.append((x.cpu(), y.cpu()))
        return kernel(pixels, x, y, *args)

    sampling.sample_kernel = recording
    try:
        out = f.render(img, device=device)
    finally:
        sampling.sample_kernel = kernel
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} sampler calls in one render")
    return out.cpu(), seen[0]


def part_coords(filters, dev, card):
    w, h = SIZES[0]
    images = {"noise": seeded_image(w, h, seed=5)[0],
              "smooth": smooth_image(w, h, seed=3, fade=False)[0],
              "smooth faded": smooth_image(w, h, seed=3)[0]}
    for name in FILTERS:
        f = filters[name]
        for iname, a in images.items():
            img = torch.from_numpy(a)
            got, (xg, yg) = sampler_coordinates(f, img.to(dev), dev)
            want, (xc, yc) = sampler_coordinates(f, img, "cpu")
            dxy = max(float((xg - xc).abs().max()), float((yg - yc).abs().max()))
            err = float((got - want).abs().max())
            print(f"coords {name:7s} {w}x{h} {iname:12s}: sampler coordinates "
                  f"card vs CPU max {dxy:.3e} px, output max abs diff "
                  f"{err:.3e} [{card}]")


def part_kernels(mt, dev, card):
    """B1's six 4K cases and the renders' 4K coordinate fields, and B4's
    interior tile, for the package `mt`."""
    from mathmap_tpu_torch.kernels import sample_image as K
    from mathmap_tpu_torch.kernels import sample_tiled as B4
    from mathmap_tpu_torch.runtime import sampling

    print(f"kernels of {Path(mt.__file__).parent}")
    time_b1(K, dev, card, sizes=SIZES[1:], with_plain=False)
    filters = {n: mt.compile_file(str(ROOT / "filters" / "Distorts" / f"{n}.mm"))
               for n in FILTERS}
    time_b1_fields(K, sampling, dev, filters, card)
    phase_tiled_timings(mt, B4, sampling, dev, {"pond": filters["pond"]}, card)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA GPU available", file=sys.stderr)
        return 1
    part = argv[0] if argv else None
    if part not in (None, "kernels", "renders", "dispatch"):
        print(f"chip_profile: unknown part {part!r} (kernels [DIR], renders [DIR] or "
              f"dispatch)", file=sys.stderr)
        return 2
    root = Path(argv[1]).resolve() if part and len(argv) > 1 else ROOT
    sys.path.insert(0, str(root))
    import mathmap_tpu_torch as mt

    dev = torch.device("cuda", 0)
    card = card_line()
    if part == "kernels":
        part_kernels(mt, dev, card)
        return 0
    if part == "renders":
        part_renders(mt, dev, card)
        return 0
    if part == "dispatch":
        part_dispatch(mt, dev, card)
        return 0
    filters = {n: mt.compile_file(str(ROOT / "filters" / "Distorts" / f"{n}.mm"))
               for n in FILTERS + ("ripple",)}
    mandelbrot = mt.compile_file(str(ROOT / "filters" / "Render" / "mandelbrot.mm"))
    stochastic = {n: mt.compile_file(str(ROOT / "filters" / folder / f"{n}.mm"))
                  for n, folder in (("turbulence", "Noise"), ("voronoi", "Render"),
                                    ("static_tv", "Noise"))}
    stochastic["rand_walk"] = mt.compile_source(RAND_WALK)
    db = mt.default_db()
    library = {n: db.compile(n) for n in LIBRARY_PROFILED}
    part_profile(mt, filters, mandelbrot, stochastic, library,
                 mt.RenderOptions(pallas_while="off"), dev, card)
    part_coords(filters, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
