"""Tests that need the card: the CUDA kernels (B1 sampler, B2 LUT, B3
generated while loop, B4 tiled sampler) against their plain PyTorch
versions, and renders on the GPU (unsharded, tiled and sharded over a mesh
of the one card) against the port's CPU renders and the unsharded card
render; rand()'s hash and Perlin noise on the card against the CPU, bit for
bit, and B3 loops that draw; quat_julia's vector loop through B3, and
gaussian_blur on the card equal to the CPU bit for bit; region renders
equal to the card's full render cropped bit for bit (B1, B2, B3, and the
tiled selection in place), corners against the CPU, the CLI, --selftest
and the render service on the card; exported artifacts on the card equal
to the live render bit for bit, each kernel launched through its op;
kernel B5 (a frame's finish) against its plain version bit for bit, and
renders, batches and the corners scheme through it equal to the eager
chain on the same planes;
kernel B6 (Perlin noise) against the eager chain bit for bit on the CPU
tests' point sets and layouts, and turbulence and voronoi through it; a
warm 4K frame that uploads no constant (utils/constants.py) but
turbulence's `t`, equal to a frame from an emptied cache bit for bit; a
warm 4K voronoi frame whose loops' memos answer their probes (18 B6
launches where a cold frame makes 32), equal to a cold frame bit for bit; a
4K ripple sweep through render_sharded over every card, and over a mesh
of one card, equal to the one-card animation bit for bit, with the bytes
that cross cards counted; a 1080p 120-frame ripple sweep at 2x2 grid
supersampling equal to its frames' lone renders bit for bit and to the
benchmark's plain reference within 1e-4, and equal bit for bit to the
same sweep walked once per subsample.

They carry the `cuda` marker and skip without a GPU. This file imports only
torch, numpy and the port (and, inside one test, the benchmark's plain
torch reference), so it also runs on a GPU machine without jax:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import os

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.kernels import apply_lut as L
from mathmap_tpu_torch.kernels import finish_rgba as B5
from mathmap_tpu_torch.kernels import perlin3 as B6
from mathmap_tpu_torch.kernels import sample_image as K
from mathmap_tpu_torch.kernels import sample_tiled as B4
from mathmap_tpu_torch.kernels import while_loop as WL
from mathmap_tpu_torch.runtime import tracer
from mathmap_tpu_torch.utils import constants
from mathmap_tpu_torch.utils.trace import counter, since, snapshot

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(__file__), "..")
HI, WI = 24, 32  # source image, non-square
H, W = 20, 28  # coordinate grid
RTOL, ATOL = 1e-4, 1e-5
INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)
#: the launch counters of B1, B2, B3 and B5
_LAUNCH_COUNTERS = ("launch.sample_image", "launch.apply_lut", "launch.while_loop",
                    "launch.finish_rgba")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _source(dtype):
    f32 = np.random.RandomState(5).rand(HI, WI, 4).astype(np.float32)
    if dtype == "u8":
        return np.floor(f32 * 255 + 0.5).astype(np.uint8)
    return f32


def _coords():
    """World coordinates in four row bands: in range, exact texel centres,
    far outside (±3·W), and within 3 px of an edge."""
    rs = np.random.RandomState(6)
    x = np.empty((H, W), np.float32)
    y = np.empty((H, W), np.float32)
    b = np.array_split(np.arange(H), 4)
    x[b[0]] = rs.uniform(-WI / 2, WI / 2, (len(b[0]), W))
    y[b[0]] = rs.uniform(-HI / 2, HI / 2, (len(b[0]), W))
    x[b[1]] = rs.randint(0, WI, (len(b[1]), W)) + 0.5 - WI / 2
    y[b[1]] = HI / 2 - 0.5 - rs.randint(0, HI, (len(b[1]), W))
    x[b[2]] = rs.uniform(-3 * WI, 3 * WI, (len(b[2]), W))
    y[b[2]] = rs.uniform(-3 * WI, 3 * WI, (len(b[2]), W))
    x[b[3]] = rs.choice([-WI / 2, WI / 2], (len(b[3]), W)) + rs.uniform(-3, 3, (len(b[3]), W))
    y[b[3]] = rs.choice([-HI / 2, HI / 2], (len(b[3]), W)) + rs.uniform(-3, 3, (len(b[3]), W))
    return x, y


def _offset_view(a):
    """A contiguous copy of `a` one element into a buffer of its own: not
    16-byte aligned."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


#: coordinate layouts -> the kernel's instantiation for nearest and
#: bilinear: W = 28 aligned takes V = 4 pixels a thread; the ragged W = 27
#: and views offset by one element take V = 1, as bicubic always does
LAYOUTS = {"aligned": 4, "ragged": 1, "offset": 1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("ex,ey", EDGE_PAIRS)
@pytest.mark.parametrize("interp", INTERPOLATIONS)
def test_cuda_kernel_matches_plain_version(cuda, interp, ex, ey, dtype, layout):
    pix = torch.from_numpy(_source(dtype)).to(cuda)
    x, y = (torch.from_numpy(a).to(cuda) for a in _coords())
    if layout == "ragged":
        x, y = x[:, :27].contiguous(), y[:, :27].contiguous()
    elif layout == "offset":
        x, y = _offset_view(x), _offset_view(y)
    before = counter("launch.sample_image")
    got = K.sample_image(pix, x, y, interp, ex, ey, EDGE_COLOR)
    want = K.sample_image_reference(pix, x, y, interp, ex, ey, EDGE_COLOR)
    torch.cuda.synchronize()
    assert counter("launch.sample_image") == before + 1
    vec = K.vector_width(x.shape[1], x.data_ptr(), y.data_ptr(), got.data_ptr(), interp)
    assert vec == (LAYOUTS[layout] if interp in K.VECTOR_INTERPOLATIONS else 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_cuda_u8_ramp_is_bit_exact(cuda, layout):
    """All 256 u8 values in every channel, sampled nearest at texel centres:
    the kernel's three-operation conversion gives u8_to_float's bits (IEEE
    division by 255) on both instantiations."""
    hi, wi = 4, 64
    v = torch.arange(hi * wi).reshape(hi, wi, 1)
    ramp = ((v + 64 * torch.arange(4)) % 256).to(torch.uint8)
    xs = torch.arange(wi, dtype=torch.float32) + 0.5 - wi / 2
    ys = hi / 2 - (torch.arange(hi, dtype=torch.float32) + 0.5)
    x, y = (t.contiguous().to(cuda) for t in torch.meshgrid(xs, ys, indexing="xy"))
    if layout == "offset":
        x, y = _offset_view(x), _offset_view(y)
    got = K.sample_image(ramp.to(cuda), x, y, "nearest", "color", "color", EDGE_COLOR)
    want = K.u8_to_float(ramp).permute(2, 0, 1)
    assert torch.equal(got.cpu().view(torch.int32), want.contiguous().view(torch.int32))


def _smooth_image(w, h):
    """A seeded 4x3 grid of colors, bilinearly interpolated and faded to the
    edge color at the border: the card's and the CPU's libm differ by a few
    ulp in the warp's coordinates, and a smooth image keeps that far below
    the tolerance (a noise image would amplify it)."""
    coarse = np.random.RandomState(7).rand(4, 5, 4)
    v = (np.arange(h) + 0.5) * (3 / h)
    u = (np.arange(w) + 0.5) * (4 / w)
    iv, iu = np.floor(v).astype(int), np.floor(u).astype(int)
    fv, fu = (v - iv)[:, None, None], (u - iu)[None, :, None]
    rows = coarse[iv] * (1 - fv) + coarse[iv + 1] * fv
    img = rows[:, iu] * (1 - fu) + rows[:, iu + 1] * fu
    window = (np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None, None]
              * np.sin(np.pi * (np.arange(w) + 0.5) / w)[None, :, None])
    return (img * window).astype(np.float32)


@pytest.mark.parametrize("name", ["fisheye", "twirl", "pond"])
def test_cuda_render_goes_through_the_kernel(cuda, name):
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", f"{name}.mm"))
    img = _smooth_image(64, 48)
    before = counter("launch.sample_image")
    got = f.render(img, t=0.3, device=cuda)
    torch.cuda.synchronize()
    assert counter("launch.sample_image") == before + 1
    assert got.device.type == "cuda" and got.shape == (48, 64, 4)
    want = f.render(img, t=0.3, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [1, 4])
@pytest.mark.parametrize("k", [2, 256, 5000])
def test_cuda_lut_kernel_matches_plain_version(cuda, k, channels):
    """Both LUT routes (shared memory, and global for 5000 x 4), positions
    below 0, above 1, exactly 0 and 1, and inside; rtol=1e-5, atol=1e-6."""
    rs = np.random.RandomState(k)
    lut = torch.from_numpy(rs.rand(k, channels).astype(np.float32).squeeze(-1)
                           if channels == 1 else rs.rand(k, channels).astype(np.float32)).to(cuda)
    pos = rs.uniform(-0.5, 1.5, (H, W)).astype(np.float32)
    pos[0, :2] = (0.0, 1.0)
    pos = torch.from_numpy(pos).to(cuda)
    before = counter("launch.apply_lut")
    got = L.apply_lut(lut, pos)
    want = L.apply_lut_reference(lut, pos)
    torch.cuda.synchronize()
    assert counter("launch.apply_lut") == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _loop_calls(f, **kw):
    calls = []
    orig = tracer.loop_kernel

    def spy(loop, flat0, mask0, max_iters):
        out = orig(loop, flat0, mask0, max_iters)
        calls.append((loop, flat0, mask0, max_iters, out))
        return out

    tracer.loop_kernel = spy
    try:
        f.render(**kw)
    finally:
        tracer.loop_kernel = orig
    return calls


@pytest.mark.parametrize("name", ["mandelbrot", "julia", "burning_ship", "tricorn", "biomorph",
                                  "quat_julia"])
def test_cuda_loop_kernel_matches_the_eager_loop(cuda, name):
    """Identical carried grids (escape counts included): --fmad=false and
    the eager ops' order make the kernel round like the eager loop."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", f"{name}.mm"))
    before = counter("launch.while_loop")
    (loop, flat0, mask0, max_iters, got), = _loop_calls(f, width=W, height=H, device=cuda)
    want, _ = WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                      loop.it_base)
    torch.cuda.synchronize()
    assert counter("launch.while_loop") == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_mandelbrot_render_launches_both_kernels(cuda):
    f = mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm"))
    before = (counter("launch.apply_lut"), counter("launch.while_loop"))
    got = f.render(width=64, height=48, device=cuda)
    torch.cuda.synchronize()
    assert ((counter("launch.apply_lut"), counter("launch.while_loop"))
            == (before[0] + 1, before[1] + 1))
    want = f.render(width=64, height=48, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


#: a loop body per builtin a kernel may call and per tag overload: p, q are
#: scalars, z an ri: value, c an rgba color (generator_source binds them);
#: tests/test_torch_while.py holds their generated programs against the
#: eager loop on the CPU, the test below their kernels on the card
GENERATOR_BODIES = {
    "arith": "v = p + q - p * q / (q + 2) % 0.7",
    "pow": "v = abs(p) ^ 0.5 + pow(abs(q) + 0.1, p)",
    "compare": "v = (p == q) + (p != q) + (p < q) + (p > q) + (p <= q) + (p >= q)",
    "logic": "v = (p > 0 && q > 0) + (p > 0 || q > 0) + (p > 0 xor q > 0) + !(p > 0)",
    "neg": "v = -p",
    "abs_sign": "v = abs(p) + sign(q) + abs(z)",
    "min_max_clamp": "v = min(p, q) + max(p, q) + clamp(p, -0.2, q)",
    "lerp_smooth": "v = lerp(p, q, 2) + smoothstep(0, 1, q) + inintv(p, -0.5, 0.5)",
    "rounding": "v = floor(p * 3) + ceil(q * 3) + round(p * 7) + fmod(p * 5, 0.7)",
    "hypot": "v = hypot(p, q)",
    "exp_log": "v = sqrt(abs(p)) + exp(q) + exp2(p) + log(abs(q) + 1) + log2(abs(p) + 1) + log10(abs(q) + 2)",
    "trig": "v = sin(p) + cos(q) + tan(p * 0.5) + tanh(q)",
    "degrees": "v = deg2rad(p * 90) + rad2deg(q)",
    "ri_mul_div": "w = z * z / (z + ri:[1, 0.5]); v = w[0] + w[1]",
    "ri_exp_log": "w = exp(z) + log(z + ri:[2, 0]); v = w[0] - w[1]",
    "ri_sqrt_pow": "w = sqrt(z) + z ^ ri:[0.5, 0.1] + pow(z, 2); v = w[0] + w[1]",
    "ri_trig": "w = sin(z) + cos(z) + tan(z * 0.5); v = w[0] * w[1]",
    "ri_scalar_div": "w = 1 / (z + ri:[0.5, 0.5]) + conj(z); v = w[0] + w[1]",
    "colors": ("k = rgbColor(p, q, 0.5) + rgbaColor(q, p, 0.25, 1) + grayColor(p) + grayaColor(q, 0.5);"
               "v = red(k) + green(k) + blue(k) + alpha(k) + gray(k)"),
    "hsva": "k = toHSVA(c); m = toRGBA(k); v = m[0] + m[1] * 2 + m[2] * 3 + k[0]",
    "toxy": "w = toXY(ra:[p + 1, q]); v = w[0] * w[1]",
    "scale": "w = scale(c, 0.5); v = w[0] + scale(p, -1, 1, 0, 10)",
    "internals": "v = r / R + a + t + X / W + Y / H + pi + e + I[1] + frame",
    "rand": "v = rand(p, q) + rand(-1, 1) * p",
    "dynamic_index": "k = [p, q, 0.5]; j = floor(abs(q) * 3); v = k[j]; k[j] = 1; v = v + k[1]",
    "if": "if p > q then v = p * 2 else v = q - 1 end",
    "tuples": ("k = clamp(c * 2 - [0.1, 0.2, 0.3, 0.4], 0, 1) + min(c, 0.5) + max(c, q);"
               "v = k[0] + k[3] + abs(xy) + abs(z * 2) + (c == c) + (c != k)"),
    "length": "v = length(c) + length(xy) + length([p, q, 0.5])",
    "dotp": "v = dotp(c, c) + dotp(xy, [p, q])",
    "crossp": "w = crossp([p, q, 0.5], v3:[q, 1, p]); v = w[0] + w[1] * w[2]",
    # floor(p) is 0 for p in [0, 1): a zero vector takes normalize's where
    "normalize": "w = normalize([p, q, 0.5]) + normalize([q, p, 1] * floor(p)); v = w[0] + w[2]",
    "quat_products": ("h = hyper:[p, q, 0.2, 0.1] * hyper:[q, p, 0.3, p];"
                      "k = quat:[p, q, 1, 0] * quat:[q, 0.5, p, 1];"
                      "m = cquat:[p, 1, q, 0] * cquat:[q, p, 1, 0.5];"
                      "v = h[0] + h[3] + k[1] + k[2] + m[2] + m[3]"),
    "matrix_products": ("m = m2x2:[p, q, 0.5, 1] * m2x2:[q, 1, p, 2]; w = m * xy;"
                        "n = m3x3:[p, q, 1, 0, 1, p, q, 0, 1] * 2; u = n * [p, q, 1];"
                        "v = w[0] + m[3] + u[1] + (n * n)[4]"),
}


def generator_source(body: str) -> str:
    """A filter whose loop runs `body` 4 times with per-pixel p, q, z, c."""
    return ("filter f () i = 0; v = 0;"
            "  while i + x * 0 < 4 do"
            "    p = x / W * 2 + i * 0.25; q = y / H * 2 - i * 0.125;"
            "    z = ri:[p, q]; c = rgbaColor(abs(p), abs(q), 0.5, 1);"
            f"    {body};"
            "    i = i + 1 end;"
            "  grayColor(v) end")


@pytest.mark.parametrize("name", sorted(GENERATOR_BODIES))
def test_cuda_generated_kernel_matches_the_eager_loop(cuda, name):
    """Every op's C spelling on the card: the compiled kernel against the
    eager loop on the same CUDA tensors, rtol=1e-4, atol=1e-5 (libm calls
    may differ in the last place between nvcc's build and PyTorch's)."""
    f = mt.compile_source(generator_source(GENERATOR_BODIES[name]))
    (loop, flat0, mask0, max_iters, got), = _loop_calls(
        f, width=W, height=H, t=0.3, frame=2.0, device=cuda)
    want, _ = WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                      loop.it_base)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)


#: (global rows, cols, tile rows, tile cols, halo_y, halo_x, tile row, tile
#: col, mesh cols): a top, an interior and a bottom row tile, a column-split
#: corner tile and a whole-frame 1-tile block
TILED_BLOCKS = [(40, 36, 10, 36, 5, 0, 0, 0, 1), (40, 36, 10, 36, 5, 0, 2, 0, 1),
                (40, 36, 10, 36, 5, 0, 3, 0, 1), (40, 36, 20, 9, 4, 4, 1, 3, 4),
                (40, 36, 40, 36, 3, 0, 0, 0, 1)]


@pytest.mark.parametrize("ex,ey", EDGE_PAIRS)
@pytest.mark.parametrize("interp", INTERPOLATIONS)
@pytest.mark.parametrize("block", range(len(TILED_BLOCKS)))
def test_cuda_tiled_kernel_matches_plain_version(cuda, block, interp, ex, ey):
    """Coordinates around the tile, in and far out of its halo: the same
    samples (rtol=1e-4, atol=1e-5) and the same excess."""
    gh, gw, th, tw, hy, hx, r, c, nx = TILED_BLOCKS[block]
    rs = np.random.RandomState(block)
    ext = torch.from_numpy(rs.rand(th + 2 * hy, tw + 2 * hx if nx > 1 else gw, 4)
                           .astype(np.float32)).to(cuda)
    x = (np.arange(c * tw, (c + 1) * tw)[None, :] + 0.5 - gw / 2) + rs.uniform(-40, 40, (th, tw))
    y = (gh / 2 - 0.5 - np.arange(r * th, (r + 1) * th)[:, None]) + rs.uniform(-40, 40, (th, tw))
    x, y = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))
    geom = dict(gh=gh, gw=gw, row_base=r * th - hy, col_base=c * tw - hx if nx > 1 else 0,
                col_sharded=nx > 1, interpolation=interp, edge_x=ex, edge_y=ey,
                edge_color=EDGE_COLOR)
    before = counter("launch.sample_tiled")
    got, excess = B4.sample_tiled(ext, x, y, **geom)
    want, want_excess = B4.sample_tiled_reference(ext, x, y, **geom)
    torch.cuda.synchronize()
    assert counter("launch.sample_tiled") == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert int(excess) == int(want_excess)
    unchecked, none = B4.sample_tiled(ext, x, y, check=False, **geom)
    assert none is None and torch.equal(unchecked, got)


def test_cuda_tiled_pond_launches_the_tiled_kernel_per_tile(cuda):
    """pond on a (1,4,1) mesh of the one card: 4 tiles, 4 B4 launches, the
    unsharded card render's values; render_sharded launches B1 per tile."""
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "pond.mm"))
    img = torch.from_numpy((_smooth_image(96, 128) * 255 + 0.5).astype(np.uint8)).to(cuda)
    mesh = mt.make_mesh(1, 4, 1, devices=[cuda] * 4)
    before = counter("launch.sample_tiled")
    got = f.render_tiled(img, mesh=mesh)
    torch.cuda.synchronize()
    assert counter("launch.sample_tiled") == before + 4
    want = f.render(img, device=cuda)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    before = counter("launch.sample_image")
    sharded = f.render_sharded(img, mesh=mesh)
    torch.cuda.synchronize()
    assert counter("launch.sample_image") == before + 4
    torch.testing.assert_close(sharded, want, rtol=RTOL, atol=ATOL)


def test_cuda_tiled_violation_raises(cuda):
    f = mt.compile_source("origVal(xy + xy:[0, 40])")
    img = torch.rand(64, 48, 4, device=cuda)
    with pytest.raises(mt.MMRuntimeError, match="bounded-displacement"):
        f.render_tiled(img, halo=4, mesh=mt.make_mesh(1, 4, 1, devices=[cuda] * 4))


def test_cuda_tiled_and_sharded_renders_across_every_card(cuda):
    """The default mesh puts every visible GPU on the rows: halo rows and
    tiles move between cards by peer copies. Tiled pond (one B4 launch per
    card), sharded pond and sharded mandelbrot equal the one-card render."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more GPUs")
    first = torch.device("cuda", 0)
    pond = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "pond.mm"))
    img = torch.from_numpy((_smooth_image(96, 32 * n) * 255 + 0.5).astype(np.uint8)).to(first)
    want = pond.render(img, device=first)
    meshes = [mt.make_mesh()] + ([mt.make_mesh(1, n // 2, 2)] if n % 2 == 0 else [])
    for mesh in meshes:
        assert {d.index for d in mesh.devices.flat} == set(range(n))
        before = counter("launch.sample_tiled")
        got = pond.render_tiled(img, mesh=mesh)
        for i in range(n):
            torch.cuda.synchronize(i)
        assert counter("launch.sample_tiled") == before + n
        assert got.device == first
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(pond.render_sharded(img, mesh=mesh), want,
                                   rtol=RTOL, atol=ATOL)
    mandelbrot = mt.compile_file(os.path.join(ROOT, "filters", "Render", "mandelbrot.mm"))
    want = mandelbrot.render(width=64, height=16 * n, device=first)
    got = mandelbrot.render_sharded(width=64, height=16 * n, mesh=mt.make_mesh())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cards", ["every", "one"])
def test_cuda_4k_sweep_over_the_mesh_equals_the_one_card_animation(cuda, cards):
    """A short 3840x2160 ripple t-sweep through render_sharded over the
    default mesh (every card on the rows; two or more cards) or a (1,4,1)
    mesh of one card equals render_animation on the first card bit for
    bit. The parallel layer counts the bytes that cross cards: (cards - 1)
    x (tile bytes x frames + input bytes), the assembled tiles and the
    input's replicas; none on one card."""
    n = torch.cuda.device_count()
    if cards == "every" and n < 2:
        pytest.skip("needs two or more GPUs")
    w, h, frames = 3840, 2160, 3
    first = torch.device("cuda", 0)
    if cards == "every":
        if h % n:
            pytest.skip(f"{h} rows do not split over {n} cards")
        mesh, crossing = mt.make_mesh(), n - 1
    else:
        mesh, crossing = mt.make_mesh(1, 4, 1, devices=[first] * 4), 0
    ripple = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "ripple.mm"))
    img = torch.from_numpy((_smooth_image(w, h) * 255 + 0.5).astype(np.uint8)).to(first)
    params = {"amplitude": 5.5, "wavelength": 45.0}
    want = ripple.render_animation(img, num_frames=frames, params=params, device=first)
    before = counter("shard.peer_bytes")
    got = ripple.render_sharded(img, mesh=mesh, num_frames=frames, params=params)
    for i in range(n):
        torch.cuda.synchronize(i)
    assert got.device == first
    assert torch.equal(got, want)
    tile_bytes = (h // mesh.devices.shape[1]) * w * 4 * 4
    assert counter("shard.peer_bytes") - before == crossing * (tile_bytes * frames + img.numel())


RAND_WALK = ("filter rand_walk () s = 0; i = 0;"
             "  while s < 1 && i < 64 do s = s + rand(0, 0.1) * (1 + x / W); i = i + 1 end;"
             "  grayColor(i / 64) end")


@pytest.mark.parametrize("fields", [{}, dict(while_static_unroll=0, seed=5)],
                         ids=["after_the_unroll", "from_iteration_1"])
def test_cuda_rand_loop_kernel_matches_the_eager_loop(cuda, fields):
    """rand() in a generated loop: mm_rand hashes like the eager ops, so the
    carried grids are identical, iterations numbered after the unroll's."""
    f = mt.compile_source(RAND_WALK)
    (loop, flat0, mask0, max_iters, got), = _loop_calls(
        f, width=W, height=H, options=mt.RenderOptions(**fields), device=cuda)
    assert loop.it_base == (0 if fields else 1)
    want, _ = WL.while_loop_reference(loop.step, flat0, mask0, max_iters, loop.unroll,
                                      loop.it_base)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cpu = f.render(width=W, height=H, options=mt.RenderOptions(**fields), device="cpu")
    assert torch.equal(f.render(width=W, height=H, options=mt.RenderOptions(**fields),
                                device=cuda).cpu(), cpu)


def test_cuda_rand_loop_tiles_draw_by_the_global_index(cuda):
    """render_sharded on a (1,2,2) mesh of the card: one B3 launch a tile,
    each with its tile's offsets, the unsharded render's pixels."""
    f = mt.compile_source(RAND_WALK)
    want = f.render(width=64, height=48, device=cuda)
    before = counter("launch.while_loop")
    got = f.render_sharded(width=64, height=48, mesh=mt.make_mesh(1, 2, 2, devices=[cuda] * 4))
    torch.cuda.synchronize()
    assert counter("launch.while_loop") == before + 4
    assert torch.equal(got, want)


def test_cuda_hash_and_noise_equal_the_cpu(cuda):
    from mathmap_tpu_torch.ops import noise as N
    from mathmap_tpu_torch.ops import rand as RND

    for salt, extra in ((RND.draw_salt(3, 7), None), (0xFFFFFFFF, 0xFFFFFFFF)):
        got = RND.rand_uniform(RND.rand_index((40, 52), 100, 8, 30, cuda), salt, extra)
        want = RND.rand_uniform(RND.rand_index((40, 52), 100, 8, 30, "cpu"), salt, extra)
        assert torch.equal(got.cpu(), want)
    rs = np.random.RandomState(4)
    pts = np.concatenate([rs.uniform(-300, 300, (3, 5000)),
                          rs.uniform(2**24, 2**40, (3, 500)),
                          [[np.nan, np.inf, -np.inf, 3e9], [0.5, 0.5, 0.5, 0.5],
                           [0.25, 0.25, 0.25, 0.25]]], axis=1).astype(np.float32)
    want = N.perlin3(*(torch.from_numpy(a) for a in pts))
    got = N.perlin3(*(torch.from_numpy(a).to(cuda) for a in pts)).cpu()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~want.isnan()], want[~want.isnan()])


@pytest.mark.parametrize("name", ["static_tv", "dissolve", "turbulence", "voronoi"])
def test_cuda_stochastic_render_matches_the_cpu(cuda, name):
    folder = {"static_tv": "Noise", "dissolve": "Combine", "turbulence": "Noise",
              "voronoi": "Render"}[name]
    f = mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))
    n = sum(1 for p in f.fdef.params if p.kind == "image")
    imgs = [_smooth_image(64, 48)] * n
    got = f.render(*imgs, width=64, height=48, t=0.3, device=cuda)
    want = f.render(*imgs, width=64, height=48, t=0.3, device="cpu")
    if name in ("static_tv", "dissolve"):
        assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


def test_cuda_gaussian_blur_equals_the_cpu(cuda):
    """The shifted-slice blur is IEEE multiplies and adds in one order, so
    the card's blur is the CPU's bit for bit (u8 and f32 sources)."""
    from mathmap_tpu_torch.runtime.native_filters import gaussian_blur_pixels

    rs = np.random.RandomState(5)
    for pix in (torch.from_numpy(rs.rand(HI, WI, 4).astype(np.float32)),
                torch.from_numpy(rs.randint(0, 256, (HI, WI, 4)).astype(np.uint8))):
        for sigma in (0.7, 1.5, 4.0):
            got = gaussian_blur_pixels(pix.to(cuda), sigma)
            assert torch.equal(got.cpu(), gaussian_blur_pixels(pix, sigma))


REG = (5, 3, 17, 11)  # unaligned origin and size inside (H, W) = (20, 28)


@pytest.mark.parametrize("name,folder", [("twirl", "Distorts"), ("fisheye", "Distorts"),
                                         ("mandelbrot", "Render")])
@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
def test_cuda_region_is_the_full_render_cropped(cuda, name, folder, out_dtype):
    """A region render launches the same kernels as the full render, on the
    region's grid, and equals its crop bit for bit."""
    f = mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))
    imgs = [torch.from_numpy(_source("u8")).to(cuda)] if f.image_params else []
    kw = dict(width=W, height=H, device=cuda)
    full = f.render(*imgs, options=mt.RenderOptions(output_dtype=out_dtype), **kw)
    counts = [counter(n) for n in _LAUNCH_COUNTERS]
    got = f.render(*imgs, options=mt.RenderOptions(output_dtype=out_dtype, region=REG), **kw)
    torch.cuda.synchronize()
    launched = [counter(n) - c for n, c in zip(_LAUNCH_COUNTERS, counts)]
    assert launched == ([1, 0, 0, 1] if f.image_params else [0, 1, 1, 1])
    x, y, w, h = REG
    assert got.shape == (h, w, 4)
    assert torch.equal(got, full[y:y + h, x:x + w])


def test_cuda_region_rand_and_tiled_in_place(cuda):
    x, y, w, h = REG
    rnd = mt.compile_source("filter n () grayColor(rand(0,1)) end")
    full = rnd.render(width=W, height=H, device=cuda)
    assert torch.equal(rnd.render(width=W, height=H, device=cuda,
                                  options=mt.RenderOptions(region=REG)),
                       full[y:y + h, x:x + w])
    f = mt.compile_source("origVal(xy + xy:[0, 2 * sin(x / 3)])")
    img = torch.from_numpy(_source("u8")[:H, :W].copy()).to(cuda)
    o = mt.RenderOptions(region=REG, output_dtype="uint8")
    got = f.render_tiled(img, halo=4, options=o, mesh=mt.make_mesh(1, 4, 1, devices=[cuda] * 4))
    lone = f.render(img, options=o, device=cuda)
    assert torch.equal(got[y:y + h, x:x + w], lone)
    mask = torch.zeros(H, W, 1, dtype=torch.bool, device=cuda)
    mask[y:y + h, x:x + w] = True
    assert torch.equal(torch.where(mask, img, got), img)


@pytest.mark.parametrize("src", ["origVal(xy + xy:[2 * sin(y / 5), 2 * cos(x / 4)])",
                                 "filter n () grayColor(rand(0,1)) end"])
def test_cuda_corners_match_the_cpu(cuda, src):
    f = mt.compile_source(src)
    imgs = [_smooth_image(W, H)] if f.image_params else []
    o = mt.RenderOptions(supersample=2, supersample_scheme="corners", region=(3, 2, 20, 15))
    got = f.render(*imgs, width=W, height=H, options=o, device=cuda)
    want = f.render(*imgs, width=W, height=H, options=o, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


def test_cuda_cli_png_equals_the_api_render(cuda, tmp_path, monkeypatch):
    from mathmap_tpu_torch.cli import main
    from mathmap_tpu_torch.imgio.images import read_animation, read_image, write_image

    monkeypatch.delenv("MMTPU_PLATFORM", raising=False)
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    write_image(str(src), _smooth_image(W, H))
    assert main([os.path.join(ROOT, "filters", "Distorts", "twirl.mm"), str(src), str(out),
                 "--param", "angle=4", "--region", "2,3,20x12"]) == 0
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "twirl.mm"))
    want = f.render(read_image(str(src)), params={"angle": 4}, device=cuda,
                    options=mt.RenderOptions(output_dtype="uint8", region=(2, 3, 20, 12)))
    np.testing.assert_array_equal(read_animation(str(out), as_uint8=True)[0],
                                  want.cpu().numpy())


def test_cuda_selftest_passes(cuda):
    from mathmap_tpu_torch.selftest import run_selftest

    assert run_selftest(size=64, device=cuda) == 0


def test_cuda_service_jobs_equal_their_lone_renders(cuda):
    import threading

    from mathmap_tpu_torch.serve import RenderService

    svc = RenderService(max_batch=8, window_ms=50.0, device=cuda)
    img = (_source("u8")).copy()
    angles = [1.0, 2.0, 3.0, 4.0]
    results = [None] * 4

    def go(i):
        results[i] = svc.render_sync("twirl", [img], WI, HI, params={"angle": angles[i]})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        svc.shutdown()
    f = mt.default_db().compile("twirl")
    for i, a in enumerate(angles):
        lone = f.render(img, params={"angle": a}, device=cuda,
                        options=mt.RenderOptions(output_dtype="uint8"))
        np.testing.assert_array_equal(results[i], lone.cpu().numpy())


#: a loop whose body reads `t` and `W`: in an exported program its scalars
#: come from device memory, in the live render by value
T_LOOP = ("filter tloop () s = 0; i = 0; while s < 1 + t && i < 60 do "
          "s = s + 0.02 + x / W * 0.01; i = i + 1 end; grayColor(i / 60) end")
ARTIFACT_CASES = {
    "twirl": ("filters/Distorts/twirl.mm", True, {"angle": 3.0}, {"angle": -2.5},
              (1, 0, 0, 1)),
    "mandelbrot": ("filters/Render/mandelbrot.mm", False, {"maxiter": 64}, {"maxiter": 90},
                   (0, 1, 1, 1)),
    "t loop": (T_LOOP, False, {}, {}, (0, 0, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(ARTIFACT_CASES))
def test_cuda_artifact_equals_the_live_render_through_the_ops(cuda, name, tmp_path):
    """An artifact exported on the card renders, batches and sweeps bit for
    bit like the live render, launching each kernel through its op."""
    from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact

    src, image, p_export, p, launches = ARTIFACT_CASES[name]
    f = (mt.compile_file(os.path.join(ROOT, src)) if src.endswith(".mm")
         else mt.compile(src))
    ins = [torch.from_numpy(_source("f32")).to(cuda)] if image else []
    path = str(tmp_path / "a.mmxa")
    export_artifact(f, path, WI, HI, params=p_export, batch_sizes=(3,), anim_frames=3,
                    device=cuda)
    art = load_artifact(path)
    assert art.platforms == ("cuda",)
    before = [counter(n) for n in _LAUNCH_COUNTERS]
    got = art.render(*ins, params=p, t=0.35)
    torch.cuda.synchronize()
    after = [counter(n) for n in _LAUNCH_COUNTERS]
    assert tuple(a - b for a, b in zip(after, before)) == launches
    want = f.render(*ins, params=p, t=0.35, width=WI, height=HI, device=cuda)
    assert torch.equal(got, want)
    ts = [0.1, 0.5, 0.9]
    stacks = [torch.stack([a] * 3) for a in ins]
    assert torch.equal(art.render_batch(*stacks, params=[p] * 3, ts=ts),
                       f.render_batch(*stacks, ts=ts, params=[p] * 3, width=WI, height=HI,
                                      device=cuda))
    assert torch.equal(art.render_animation(*ins, params=p),
                       f.render_animation(*ins, num_frames=3, params=p, width=WI, height=HI,
                                          device=cuda))


#: values every B5 plane holds somewhere: NaN, ±inf, signed zeros, the
#: clamp's ends and either side of them, the uint8 pack's rounding edges
FINISH_SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1e-8, 1 + 1e-7,
                            0.5 / 255, 1.5 / 255, 127.5 / 255, 254.5 / 255, 3e38, -3e38],
                           np.float32)


def _finish_values(shape, seed: int, dev) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    v = rs.uniform(-0.5, 1.5, shape).astype(np.float32).reshape(-1)
    at = rs.choice(v.size, min(v.size, len(FINISH_SPECIALS)), replace=False)
    v[at] = FINISH_SPECIALS[:len(at)]
    return torch.from_numpy(v.reshape(shape)).to(dev)


def _finish_planes(layout: str, h: int, w: int, dev) -> list:
    """Four (h, w) planes: contiguous (a sampler's or LUT's unbound
    output), stride 0 (moire's constant alpha and the two coordinate
    grids' broadcasts beside one contiguous plane) or strided views."""
    if layout == "contiguous":
        return list(_finish_values((4, h, w), 0, dev).unbind(0))
    if layout == "stride 0":
        return [_finish_values((h, w), 1, dev),
                torch.broadcast_to(_finish_values((w,), 2, dev)[None, :], (h, w)),
                torch.broadcast_to(_finish_values((h,), 3, dev)[:, None], (h, w)),
                torch.broadcast_to(_finish_values((1,), 4, dev)[0], (h, w))]
    return [_finish_values((w, h), s, dev).t() for s in range(4)]


def _unaligned_out(h: int, w: int, dtype, dev) -> torch.Tensor:
    """An (h, w, 4) output one element into a buffer of its own."""
    return torch.empty(h * w * 4 + 1, dtype=dtype, device=dev)[1:].view(h, w, 4)


def _wide(out: torch.Tensor) -> bool:
    return B5.wide_stores(out.data_ptr(), out.stride(0) * out.element_size(),
                          out.dtype == torch.uint8)


#: B5 cases: (h, w, plane layout, out, whether the launch stores a pixel at
#: once); a ragged width and 1x1 mask the row's end, the unaligned output
#: takes the narrow instantiation
FINISH_CASES = {
    "4k": (2160, 3840, "contiguous", "new", True),
    "1080p": (1080, 1920, "contiguous", "new", True),
    "1080p batch slice": (1080, 1920, "contiguous", "batch", True),
    "ragged": (37, 1919, "contiguous", "new", True),
    "1x1": (1, 1, "contiguous", "new", True),
    "unaligned out": (64, 128, "contiguous", "unaligned", False),
    "stride 0": (1080, 1920, "stride 0", "new", True),
    "strided views": (72, 128, "views", "new", True),
}


@pytest.mark.parametrize("supersample", [1, 3])
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("case", sorted(FINISH_CASES))
def test_cuda_finish_kernel_equals_its_plain_version_bit_for_bit(cuda, case, u8, supersample):
    h, w, layout, out_kind, wide = FINISH_CASES[case]
    planes = _finish_planes(layout, h, w, cuda)
    inv = 1.0 / (supersample * supersample)
    dtype = torch.uint8 if u8 else torch.float32
    batch = None
    if out_kind == "batch":
        batch = torch.full((3, h, w, 4), 7, dtype=dtype, device=cuda)
        out = batch[1]
    elif out_kind == "unaligned":
        out = _unaligned_out(h, w, dtype, cuda)
    else:
        out = torch.empty((h, w, 4), dtype=dtype, device=cuda)
    assert _wide(out) is wide
    before = counter("launch.finish_rgba")
    got = B5.finish_rgba(planes, inv, u8, None if out_kind == "new" else out)
    want = B5.finish_rgba_reference(planes, inv, u8)
    torch.cuda.synchronize()
    assert counter("launch.finish_rgba") == before + 1
    assert got.dtype == dtype and got.shape == (h, w, 4)
    bits = (lambda t: t.view(torch.int32)) if not u8 else (lambda t: t)
    assert torch.equal(bits(got), bits(want))
    if batch is not None:
        assert bool((batch[0] == 7).all()) and bool((batch[2] == 7).all())


def test_cuda_finish_kernel_raises_on_what_it_does_not_take(cuda):
    planes = list(torch.zeros((4, 8, 12), device=cuda).unbind(0))
    with pytest.raises(ValueError, match="finish_rgba takes"):
        torch.ops.mathmap.finish_rgba_out(*planes, 1.0, torch.empty((4, 8, 12), device=cuda)
                                          .permute(1, 2, 0))
    with pytest.raises(ValueError, match="finish_rgba takes"):
        torch.ops.mathmap.finish_rgba(*planes[:3], planes[3].double(), 1.0, False)


#: the filters of the benchmark's cells, by folder
FINISH_FILTERS = {"fisheye": "Distorts", "twirl": "Distorts", "pond": "Distorts",
                  "mandelbrot": "Render", "moire": "Render"}


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name", sorted(FINISH_FILTERS))
def test_cuda_frames_finish_in_the_kernel_as_on_the_eager_route(cuda, name, output_dtype,
                                                               monkeypatch):
    """Filter.render and render_batch on the card finish each frame in one
    B5 launch, and each frame equals `finish_rgba_reference` (the eager
    chain) of the same planes bit for bit."""
    f = mt.compile_file(os.path.join(ROOT, "filters", FINISH_FILTERS[name], f"{name}.mm"))
    img = torch.from_numpy(_source("u8")).to(cuda)
    opts = mt.RenderOptions(output_dtype=output_dtype)
    ins = [img] if f.image_params else []
    calls = _finish_spy(monkeypatch)
    before = counter("launch.finish_rgba")
    lone = f.render(*ins, t=0.3, options=opts, width=W, height=H, device=cuda)
    batch = f.render_batch(*[mt.shared(a) for a in ins], ts=[0.1, 0.5, 0.9], options=opts,
                           width=W, height=H, device=cuda)
    torch.cuda.synchronize()
    assert counter("launch.finish_rgba") - before == 4 and len(calls) == 4
    for (planes, inv, u8), frame in zip(calls, [lone, *batch]):
        assert inv == 1.0 and u8 == (output_dtype == "uint8")
        assert torch.equal(_finish_bits(frame), _finish_bits(
            B5.finish_rgba_reference(planes, inv, u8)))


def _finish_spy(monkeypatch) -> list:
    """Spy on render_frame's finish: each call's (planes, inv, u8)."""
    calls = []
    real = B5.finish_rgba

    def spy(planes, inv, u8, out=None):
        calls.append((planes, inv, u8))
        return real(planes, inv, u8, out)

    monkeypatch.setattr(B5, "finish_rgba", spy)
    return calls


def _finish_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name", ["twirl", "moire"])
def test_cuda_corners_finish_in_the_kernel_as_the_old_composition(cuda, name, output_dtype,
                                                                  monkeypatch):
    """The corners scheme hands B5 the five samples' sum (four channel
    views of one (H, W, 4) tensor) with inv = 0.2: one launch, and the bits
    of the sum times 0.2, clamped (and packed), that it finished with
    before."""
    f = mt.compile_file(os.path.join(ROOT, "filters", FINISH_FILTERS[name], f"{name}.mm"))
    ins = [torch.from_numpy(_source("f32")).to(cuda)] if f.image_params else []
    opts = mt.RenderOptions(supersample=2, supersample_scheme="corners",
                            output_dtype=output_dtype)
    calls = _finish_spy(monkeypatch)
    before = counter("launch.finish_rgba")
    got = f.render(*ins, t=0.3, options=opts, width=W, height=H, device=cuda)
    torch.cuda.synchronize()
    assert counter("launch.finish_rgba") - before == 1
    (planes, inv, u8), = calls
    assert inv == 0.2 and u8 == (output_dtype == "uint8")
    rgba = torch.stack(planes, dim=-1) * 0.2
    want = B5.pack_uint8(rgba) if u8 else torch.clamp(rgba, 0.0, 1.0)
    assert torch.equal(_finish_bits(got), _finish_bits(want))


#: B6's point sets: the CPU tests' (tests/test_torch_noise.py's COORDS,
#: rebuilt here without importing that file, which imports jax) and the
#: specials
_RS6 = np.random.RandomState(0)
PERLIN_POINTS = {
    "random": _RS6.uniform(-50, 50, (3, 4096)),
    "negative": -_RS6.uniform(0, 300, (3, 2048)),
    "lattice": _RS6.randint(-600, 600, (3, 2048)).astype(np.float64),
    "near_lattice": (_RS6.randint(-40, 40, (3, 2048))
                     + _RS6.choice([-1e-6, 0.0, 1e-6, 0.5], (3, 2048))),
    "above_2_24": _RS6.choice([-1, 1], (3, 2048)) * _RS6.uniform(2**24, 2**30, (3, 2048)),
    "above_2_31": _RS6.choice([-1, 1], (3, 1024)) * _RS6.uniform(2**31, 2**40, (3, 1024)),
    "mixed_large": np.stack([_RS6.uniform(2**31, 2**33, 1024), _RS6.uniform(-9, 9, 1024),
                             _RS6.uniform(-9, 9, 1024)]),
    "nan_inf": np.stack([np.array([np.nan, np.inf, -np.inf, 0.5, 1.0, 7.25] * 8),
                         np.array([0.3, 0.2, -4.5, np.nan, np.inf, -np.inf] * 8),
                         np.tile([0.1, -0.7, 2.5], 16)]),
    "signed_zero": np.stack([np.tile([-0.0, 0.0, -1.0, 1.0], 8), np.tile([0.0, -0.0], 16),
                             np.tile([-0.0, 0.5], 16)]),
}


def _perlin_bits_equal(x, y, z):
    """B6 on the card against the eager chain on the same tensors, bit for
    bit (NaN, ±inf and -0.0 as bits); one launch."""
    before = counter("launch.perlin3")
    got = B6.perlin3(x, y, z)
    want = B6.perlin3_reference(x, y, z)
    torch.cuda.synchronize()
    assert counter("launch.perlin3") == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("name", sorted(PERLIN_POINTS))
def test_cuda_perlin3_kernel_equals_the_eager_chain_bit_for_bit(cuda, name):
    x, y, z = (torch.from_numpy(a).to(cuda) for a in PERLIN_POINTS[name].astype(np.float32))
    _perlin_bits_equal(x, y, z)


def _perlin_values(shape, seed: int, dev) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    v = rs.uniform(-40, 40, shape).astype(np.float32).reshape(-1)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 2.0**31, -3e9, 1e20], np.float32)
    at = rs.choice(v.size, min(v.size, len(specials)), replace=False)
    v[at] = specials[:len(at)]
    return torch.from_numpy(v.reshape(shape)).to(dev)


#: (x, y, z) shapes or layouts as the evaluator hands them: 0-d, a row, a
#: column, stride 0, a strided tile slice, a (job, H, W) batch, a ragged
#: width (one store a point) and 4K planes with a 0-d z (the cell's calls)
PERLIN_LAYOUTS = {
    "0-d": lambda d: (_perlin_values((), 1, d), _perlin_values((), 2, d),
                      _perlin_values((), 3, d)),
    "row and column": lambda d: (_perlin_values((1, W), 1, d), _perlin_values((H, 1), 2, d),
                                 _perlin_values((), 3, d)),
    "stride 0": lambda d: (_perlin_values((W,), 1, d).expand(H, W),
                           _perlin_values((H, 1), 2, d).expand(H, W),
                           torch.tensor(0.5, device=d).expand(H, W)),
    "tile slice": lambda d: tuple(_perlin_values((3 * H, 2 * W + 3), s, d)[H:2 * H, 3::2]
                                  for s in (1, 2, 3)),
    "batch": lambda d: (_perlin_values((3, H, W), 1, d), _perlin_values((H, W), 2, d),
                        _perlin_values((3, 1, 1), 3, d)),
    "ragged": lambda d: (_perlin_values((37, 1919), 1, d), _perlin_values((37, 1919), 2, d),
                         _perlin_values((), 3, d)),
    "4k planes, 0-d z": lambda d: (_perlin_values((2160, 3840), 1, d),
                                   _perlin_values((2160, 3840), 2, d),
                                   torch.tensor(0.37, device=d)),
}


@pytest.mark.parametrize("layout", sorted(PERLIN_LAYOUTS))
def test_cuda_perlin3_kernel_equals_the_eager_chain_on_every_layout(cuda, layout):
    _perlin_bits_equal(*PERLIN_LAYOUTS[layout](cuda))


def test_cuda_perlin3_launch_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((2, 2, H, W), device=cuda)
    with pytest.raises(ValueError, match="perlin3 takes"):
        torch.ops.mathmap.perlin3(x, x, x)
    with pytest.raises(ValueError, match="perlin3 takes"):
        torch.ops.mathmap.perlin3(x[0, 0].double(), x[0, 0], x[0, 0])


@pytest.mark.parametrize("name,calls", [("turbulence", 4), ("voronoi", 32)])
def test_cuda_noise_renders_go_through_the_kernel(cuda, name, calls):
    """A turbulence frame launches B6 4 times and a voronoi frame 32 (its
    loop probes' calls included), every point goes through the kernel,
    and the frame equals the CPU render bit for bit (the noise cell's
    filters read worst_abs 0.0 against their reference on the card)."""
    folder = {"turbulence": "Noise", "voronoi": "Render"}[name]
    f = mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))
    names = ("launch.perlin3", "noise.points", "noise.kernel_points")
    before = [counter(n) for n in names]
    got = f.render(width=96, height=54, t=0.3, device=cuda)
    torch.cuda.synchronize()
    launches, points, kernel_points = (counter(n) - b for n, b in zip(names, before))
    assert launches == calls and points == kernel_points == calls * 96 * 54
    want = f.render(width=96, height=54, t=0.3, device="cpu")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name,folder,misses", [("turbulence", "Noise", 1),
                                                ("voronoi", "Render", 0),
                                                ("fisheye", "Distorts", 0)])
def test_cuda_a_warm_4k_frame_uploads_no_constant(cuda, name, folder, misses):
    """After one 4K frame the constants are on the card: the next frame
    opens no `mm.sync.literal` span but turbulence's `t`, and equals a frame
    rendered after emptying the cache bit for bit."""
    f = mt.compile_file(os.path.join(ROOT, "filters", folder, f"{name}.mm"))
    gen = torch.Generator(device=cuda).manual_seed(19)
    img = torch.randint(0, 256, (2160, 3840, 4), dtype=torch.uint8, device=cuda, generator=gen)
    ins = [img] * len(f.image_params)
    f.render(*ins, width=3840, height=2160, t=0.3, device=cuda)
    before = snapshot()
    got = f.render(*ins, width=3840, height=2160, t=0.4, device=cuda)
    torch.cuda.synchronize()
    d = since(before)
    assert d["spans"].get("mm.sync.literal", {}).get("count", 0) == misses
    assert d["counters"]["literal.cached"] > 0
    constants.clear()
    want = f.render(*ins, width=3840, height=2160, t=0.4, device=cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_a_warm_4k_voronoi_frame_runs_no_probe(cuda):
    """A cold 4K voronoi frame launches B6 32 times, 14 of them in its loop
    probes; the next frame finds the outer loop's probe outcome and the 3
    inner ones in the loops' memos (`probe.cached` 4, no `mm.loop.probe`)
    and launches B6 18 times. The warm frame equals a cold frame of a
    freshly compiled filter at the same t bit for bit."""
    path = os.path.join(ROOT, "filters", "Render", "voronoi.mm")
    f = mt.compile_file(path)
    got = []
    for t in (0.3, 0.4):
        before = snapshot()
        out = f.render(width=3840, height=2160, t=t, device=cuda)
        torch.cuda.synchronize()
        d = since(before)
        got.append((d["counters"]["launch.perlin3"], d["counters"].get("probe.cached", 0),
                    d["spans"].get("mm.loop.probe", {}).get("count", 0)))
    assert got == [(32, 0, 5), (18, 4, 0)]
    cold = mt.compile_file(path).render(width=3840, height=2160, t=0.4, device=cuda)
    assert torch.equal(out.view(torch.int32), cold.view(torch.int32))


def test_cuda_a_sharded_voronoi_shares_its_probes_across_cards(cuda):
    """Over the default mesh (every card on the rows; two or more cards)
    the tiles of a voronoi frame share one memo of its loops' probes: the
    first frame probes 5 times on its first tile and finds the 4 outcomes
    a tile reads for every other tile; the next frame probes none. Both
    equal the one-card render bit for bit."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more GPUs")
    path = os.path.join(ROOT, "filters", "Render", "voronoi.mm")
    f = mt.compile_file(path)
    first = torch.device("cuda", 0)
    got = []
    for t in (0.3, 0.4):
        before = snapshot()
        out = f.render_sharded(width=64, height=16 * n, mesh=mt.make_mesh(), t=t)
        for i in range(n):
            torch.cuda.synchronize(i)
        d = since(before)
        got.append((d["counters"]["launch.perlin3"], d["counters"].get("probe.cached", 0),
                    d["spans"].get("mm.loop.probe", {}).get("count", 0)))
        assert out.device == first
        want = mt.compile_file(path).render(width=64, height=16 * n, t=t, device=first)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert got == [(32 + 18 * (n - 1), 4 * (n - 1), 5), (18 * n, 4 * n, 0)]


def test_cuda_1080p_antialiased_sweep_equals_its_lone_renders_and_the_reference(cuda):
    """The cell ripple_anim_1080p's call: a 120-frame 1920x1080 ripple
    t-sweep through render_animation at supersample 2 (the 2x2 grid) over
    the cell's textured input. Frames 0, 57 and 119 each equal the lone
    render at the sweep's float32 t bit for bit, and lie within the cell's
    1e-4 of the benchmark's plain reference (bench_torch/reference/
    supersample.py, plain torch) on the card; every frame walks the body
    once (its four subsamples stacked) and evaluates four samples a
    pixel."""
    from bench_torch.harness import images
    from bench_torch.reference import supersample

    w, h, frames, seed = 1920, 1080, 120, 2**31 + 5
    ripple = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "ripple.mm"))
    img = images.textured(images.smooth_image(w, h, seed, cuda), 16, seed)
    params = {"amplitude": 5.5, "wavelength": 45.0}
    opts = mt.RenderOptions(supersample=2)
    before = snapshot()
    sweep = ripple.render_animation(img, num_frames=frames, params=params, options=opts,
                                    device=cuda)
    torch.cuda.synchronize()
    counters = since(before)["counters"]
    assert counters["render.walks"] == frames
    assert counters["render.samples"] == 4 * counters["render.pixels"] == 4 * frames * w * h
    ts = np.arange(frames, dtype=np.float32) / frames
    for i in (0, 57, 119):
        lone = ripple.render(img, t=float(ts[i]), params=params, options=opts, device=cuda)
        assert torch.equal(sweep[i], lone), i
        want = supersample.ripple(params, float(ts[i]), w, h, img, torch.float32, cuda)
        assert float((sweep[i] - want).abs().max()) <= 1e-4, i


def test_cuda_stacked_1080p_sweep_equals_the_per_walk_sweep(cuda, monkeypatch):
    """The cell ripple_anim_1080p's call with the four subsamples stacked
    in one walk a frame equals the same sweep walked once per subsample
    (runtime/render.py::WALK_POINTS set to one subsample's points) bit for
    bit on the card, with 1 and 4 walks a frame; a 4K frame at s = 3 (walks
    of 4, 4 and 1) equals its per-walk frame too. It prints the 4K frame's
    peak memory above what was allocated before it, stacked and per walk:
    a walk of four 4K subsamples (33.2 M points, just under WALK_POINTS)
    is the largest a frame makes, and must stay within half the card."""
    from bench_torch.harness import images

    from mathmap_tpu_torch.runtime import render as R

    w, h, frames, seed = 1920, 1080, 120, 2**31 + 9
    ripple = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "ripple.mm"))
    img = images.textured(images.smooth_image(w, h, seed, cuda), 16, seed)
    params = {"amplitude": 4.5, "wavelength": 55.0}
    opts = mt.RenderOptions(supersample=2)

    peaks = []

    def walked(points, render):
        with monkeypatch.context() as m:
            if points is not None:
                m.setattr(R, "WALK_POINTS", points)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(cuda)
            base = torch.cuda.memory_allocated(cuda)
            before = snapshot()
            out = render()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated(cuda) - base)
            return out, since(before)["counters"]["render.walks"]

    def sweep():
        return ripple.render_animation(img, num_frames=frames, params=params,
                                       options=opts, device=cuda)

    stacked, walks = walked(None, sweep)
    per_walk, per_walks = walked(w * h, sweep)
    assert (walks, per_walks) == (frames, 4 * frames)
    assert torch.equal(stacked.view(torch.int32), per_walk.view(torch.int32))
    del stacked, per_walk

    img4k = images.textured(images.smooth_image(3840, 2160, seed, cuda), 16, seed)

    def frame():
        return ripple.render(img4k, t=0.3, params=params, device=cuda,
                             options=mt.RenderOptions(supersample=3))

    grouped, walks = walked(None, frame)
    one, one_walks = walked(3840 * 2160, frame)
    assert (walks, one_walks) == (3, 9)
    assert torch.equal(grouped.view(torch.int32), one.view(torch.int32))
    total = torch.cuda.get_device_properties(cuda).total_memory
    print(f"4K supersample=3 frame peak above its inputs: {peaks[-2]} bytes in walks of "
          f"4, 4 and 1, {peaks[-1]} bytes in 9 walks of one ({total} on the card)")
    assert peaks[-2] < total // 2
