"""`Filter.render_batch` and `shared()` of the port on the CPU: the cases of
tests/test_render_batch_shared.py, each job held against the reference's
NumPy oracle (`interpret=True`) rendering that job alone at its t, frame
and params, at rtol=1e-4, atol=1e-5 (uint8 outputs bit for bit); each job
equal to the port's lone render bit for bit; a shared input equal to the
broadcast stack bit for bit and staged once; a rand() batch (static_tv)
against the oracle job by job; and the distinct-op count of mandelbrot's
loop that kernel B3's bound reads.

The reference's two TPU prepad tests (the padded sampler image hoisted out
of the job loop) have no counterpart: the port samples the staged input
itself.
"""

import os

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch import api
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.runtime import tracer
from mathmap_tpu_torch.utils.trace import since, snapshot

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W = 36, 48
RTOL, ATOL = 1e-4, 1e-5

_TS = (np.arange(5, dtype=np.float32) + 0.37) / 5
_PLIST = [{"angle": 3.0 + 0.05 * i} for i in range(5)]


def _u8(seed=1, shape=(H, W, 4)):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)


def _twirl(pkg):
    return pkg.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))


def _oracle_jobs(ref, inputs_of, ts, frames, params_of, opts=None):
    """The oracle's lone render of every job -> (N, H, W, 4)."""
    return np.stack([np.asarray(ref.render(*inputs_of(i), t=float(ts[i]), frame=float(frames[i]),
                                           params=params_of(i), width=W, height=H,
                                           options=opts, interpret=True))
                     for i in range(len(ts))])


def _assert_oracle(got, want):
    if want.dtype == np.uint8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shared_dict_params_and_u8_output():
    port, ref = _twirl(mt), _twirl(mm)
    img = _u8(2)
    stack = np.broadcast_to(img, (5,) + img.shape)
    for odt in ("float32", "uint8"):
        ropts = mm.RenderOptions(output_dtype=odt)
        opts = options_from_reference(ropts)
        a = port.render_batch(stack.copy(), ts=_TS, params={"angle": 2.0}, width=W, height=H,
                              options=opts, device="cpu")
        b = port.render_batch(mt.shared(img), ts=_TS, params={"angle": 2.0}, width=W, height=H,
                              options=opts, device="cpu")
        assert a.dtype == getattr(torch, odt)
        assert torch.equal(a, b)
        want = _oracle_jobs(ref, lambda i: (img,), _TS, range(5), lambda i: {"angle": 2.0},
                            ropts)
        _assert_oracle(b, want)


def test_mixed_shared_and_per_job_inputs():
    """A two-input filter with one shared and one per-job input keeps
    position order, equals the fully stacked form bit for bit and each
    job the oracle's."""
    src = "filter m (image a, image b) (a(xy) + b(xy))/2 end"
    port, ref = mt.compile_source(src), mm.compile(src)
    base = _u8(3).astype(np.float32) / np.float32(255.0)
    other = np.stack([np.random.RandomState(10 + i).rand(H, W, 4).astype(np.float32)
                      for i in range(5)])
    a = port.render_batch(np.broadcast_to(base, (5,) + base.shape).copy(), other, ts=_TS,
                          width=W, height=H, device="cpu")
    b = port.render_batch(mt.shared(base), other, ts=_TS, width=W, height=H, device="cpu")
    assert torch.equal(a, b)
    _assert_oracle(b, _oracle_jobs(ref, lambda i: (base, other[i]), _TS, range(5),
                                   lambda i: {}))


def test_animated_shared_stack_matches_per_frame():
    """A shared (T, H, W, 4) ANIMATED stack with per-job frame selection:
    each job equals the port's lone render at its frame bit for bit, and
    the oracle's."""
    src = "filter s (image in) in(xy) end"
    port, ref = mt.compile_source(src), mm.compile(src)
    anim = _u8(4, (3, H, W, 4))
    fr = np.float32([0, 1, 2, 1, 0])
    ts = np.zeros(5, np.float32)
    b = port.render_batch(mt.shared(anim), ts=ts, frames=fr, width=W, height=H, device="cpu")
    per = torch.stack([port.render(anim, frame=float(fr[i]), t=0.0, width=W, height=H,
                                   device="cpu") for i in range(5)])
    assert torch.equal(b, per)
    _assert_oracle(b, _oracle_jobs(ref, lambda i: (anim,), ts, fr, lambda i: {}))


def test_all_shared_batch_size_from_ts_or_params():
    port = _twirl(mt)
    img = _u8(5)
    out = port.render_batch(mt.shared(img), ts=_TS, width=W, height=H, device="cpu")
    assert out.shape == (5, H, W, 4)
    out = port.render_batch(mt.shared(img), params=_PLIST, width=W, height=H, device="cpu")
    assert out.shape == (5, H, W, 4)
    out = port.render_batch(mt.shared(img), width=W, height=H, device="cpu")
    assert out.shape == (1, H, W, 4)


def test_unwrapped_lone_frame_still_raises():
    """The lone-(H,W,C) guard: without shared() a single frame is rejected
    (it would silently iterate over rows)."""
    port = _twirl(mt)
    with pytest.raises(ValueError, match="leading batch axis"):
        port.render_batch(_u8(6), ts=_TS, width=W, height=H, device="cpu")
    with pytest.raises(ValueError, match="leading batch axis"):
        port.render_batch(torch.from_numpy(_u8(6)), ts=_TS, width=W, height=H, device="cpu")


def test_batch_leading_dim_mismatch_is_readable():
    """Batch axes that differ, and ts, frames or param lists whose length
    is not the batch size, raise a clear ValueError at the API boundary."""
    port = _twirl(mt)
    stack3 = np.random.RandomState(3).rand(3, H, W, 4).astype(np.float32)
    stack4 = np.random.RandomState(4).rand(4, H, W, 4).astype(np.float32)
    with pytest.raises(ValueError, match="4 ts for a batch of 3"):
        port.render_batch(stack3, ts=[0.0, 0.1, 0.2, 0.3], width=W, height=H, device="cpu")
    with pytest.raises(ValueError, match="2 frames for a batch of 3"):
        port.render_batch(stack3, ts=[0.0, 0.1, 0.2], frames=[0.0, 1.0], width=W, height=H,
                          device="cpu")
    with pytest.raises(ValueError, match="4 param dicts for a batch of 3"):
        port.render_batch(stack3, params=[{}] * 4, width=W, height=H, device="cpu")
    with pytest.raises(ValueError, match="same names"):
        port.render_batch(stack3, params=[{"angle": 1.0}, {}, {"angle": 2.0}], width=W,
                          height=H, device="cpu")
    blend = mt.compile_source("filter m (image a, image b) (a(xy) + b(xy))/2 end")
    with pytest.raises(ValueError, match="share a leading batch axis"):
        blend.render_batch(stack3, stack4, width=W, height=H, device="cpu")


def test_uses_sampling_sees_aliased_image():
    """`q = in; q(xy)` samples through a local alias: a batch of it equals
    the oracle's renders job by job."""
    src = "filter f (image in) q = in; q(xy * 0.9) end"
    port, ref = mt.compile_source(src), mm.compile(src)
    stack = np.random.RandomState(2).rand(3, H, W, 4).astype(np.float32)
    got = port.render_batch(stack, width=W, height=H, device="cpu")
    _assert_oracle(got, _oracle_jobs(ref, lambda i: (stack[i],), np.zeros(3), range(3),
                                     lambda i: {}))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_shared_matches_stacked_bitwise(dtype):
    """shared() equals the broadcast-stacked form bit for bit, with per-job
    params, and every job equals its lone render bit for bit and the
    oracle's within the tolerance."""
    port, ref = _twirl(mt), _twirl(mm)
    img = _u8()
    inp = img if dtype == "u8" else img.astype(np.float32) / np.float32(255.0)
    stack = np.broadcast_to(inp, (5,) + inp.shape).copy()
    a = port.render_batch(stack, ts=_TS, params=_PLIST, width=W, height=H, device="cpu")
    b = port.render_batch(mt.shared(inp), ts=_TS, params=_PLIST, width=W, height=H,
                          device="cpu")
    assert torch.equal(a, b)
    for i in range(5):
        lone = port.render(inp, t=float(_TS[i]), frame=float(i), params=_PLIST[i], width=W,
                           height=H, device="cpu")
        assert torch.equal(b[i], lone)
    _assert_oracle(b, _oracle_jobs(ref, lambda i: (inp,), _TS, range(5), lambda i: _PLIST[i]))


def test_a_shared_input_is_staged_once(monkeypatch):
    """A shared input is staged on the device once for the whole batch, a
    per-job stack once as a whole: never once a job."""
    calls = []
    stage = api._stage_input

    def counting(a, device):
        calls.append(tuple(np.shape(a)))
        return stage(a, device)

    monkeypatch.setattr(api, "_stage_input", counting)
    f = mt.compile_source("filter m (image a, image b) (a(xy) + b(xy))/2 end")
    stack = np.random.RandomState(7).rand(5, H, W, 4).astype(np.float32)
    out = f.render_batch(mt.shared(_u8(8)), stack, ts=_TS, width=W, height=H, device="cpu")
    assert out.shape == (5, H, W, 4)
    assert calls == [(H, W, 4), (5, H, W, 4)]


@pytest.mark.parametrize("seed", [0, 5])
def test_rand_batch_matches_the_oracle_job_by_job(seed):
    """rand() in a batch (static_tv): a draw's salt folds the seed and the
    counter, not t or the frame, so every job draws what the oracle's lone
    render draws, bit for bit."""
    path = os.path.join(ROOT, "filters", "Noise", "static_tv.mm")
    port, ref = mt.compile_file(path), mm.compile_file(path)
    ropts = mm.RenderOptions(seed=seed)
    stack = np.stack([_u8(20 + i) for i in range(3)])
    params = [{"amount": a} for a in (0.2, 0.5, 0.9)]
    ts = np.float32([0.1, 0.4, 0.7])
    got = port.render_batch(stack, ts=ts, params=params, width=W, height=H,
                            options=options_from_reference(ropts), device="cpu")
    want = _oracle_jobs(ref, lambda i: (stack[i],), ts, range(3), lambda i: params[i], ropts)
    _assert_oracle(got, want)


def test_a_mandelbrot_batch_with_per_job_params_matches_the_oracle():
    """Per-job params of a loop filter: each job equals its lone render and
    the oracle's, and the loop takes the kernel route (here its plain
    version) in every job."""
    path = os.path.join(ROOT, "filters", "Render", "mandelbrot.mm")
    port, ref = mt.compile_file(path), mm.compile_file(path)
    params = [{"zoom": z, "cx": cx, "cy": cy, "maxiter": 40}
              for z, cx, cy in ((1.0, -0.5, 0.0), (2.0, -0.75, 0.1), (3.0, 0.25, 0.5))]
    before = snapshot()
    got = port.render_batch(params=params, frames=[0.0] * 3, width=W, height=H, device="cpu")
    assert {k: n for k, n in since(before)["counters"].items() if k.startswith("loop.")} \
        == {"loop.kernel": 3, "loop.kernel.steps": 3 * 10000}
    for i, p in enumerate(params):
        assert torch.equal(got[i], port.render(params=p, width=W, height=H, device="cpu"))
    _assert_oracle(got, _oracle_jobs(ref, lambda i: (), np.zeros(3), [0.0] * 3,
                                     lambda i: params[i]))


def test_n_distinct_ops_of_mandelbrots_loop():
    """Kernel B3's operations bound counts mandelbrot's step as 12 ops, not
    the 21 of its op list: z[1]*z[0] is z[0]*z[1]; each bool turned to
    float and compared != 0 is the bool; and the condition's z[0]*z[0] and
    z[1]*z[1] are the next body's."""
    seen = []
    spy_target = tracer.loop_kernel

    def spy(loop, flat0, mask0, max_iters):
        seen.append((loop, len(flat0)))
        return spy_target(loop, flat0, mask0, max_iters)

    tracer.loop_kernel = spy
    try:
        mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm")).render(
            width=16, height=8, device="cpu")
    finally:
        tracer.loop_kernel = spy_target
    prog = tracer.trace(*seen[0])
    assert prog.n_compute_ops() == 21
    assert prog.n_distinct_ops() == 12
