"""Kernel B6, Perlin noise (`mathmap_tpu_torch/kernels/perlin3.py`), on the
CPU: the op `mathmap::perlin3`'s CPU implementation (what every `noise`
call on the CPU runs) against the JAX package's NumPy `perlin3` bit for
bit on test_torch_noise.py's point sets and on the broadcast layouts the
evaluator hands a `noise` call (0-d, a row, a column, stride 0, a strided
tile slice, a (job, H, W) batch), NaN, ±inf, -0.0 and |f| >= 2^31
included; its fake implementation's shape; the launch's refusals and its
stores (`wide_stores`); the `noise` builtin's route and counters
(`noise.points`, and `noise.kernel_points` on the card, traced here with
fake CUDA tensors), batches equal to their lone renders, and artifacts
that hold `mathmap::perlin3`, a loop's `while_loop` body included. The
kernel itself runs on the card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mathmap_tpu.ops import noise as ref_noise
from mathmap_tpu_torch.generators.artifact import export_artifact, load_artifact
from mathmap_tpu_torch.kernels import perlin3 as B6
from mathmap_tpu_torch.ops import noise as N
from mathmap_tpu_torch.runtime.value import TupleValue
from mathmap_tpu_torch.typesys.tags import NIL
from mathmap_tpu_torch.utils.trace import snapshot, since
from test_torch_noise import COORDS
from test_torch_render import _library_filter

H, W = 9, 14
#: special coordinates: NaN, ±inf, signed zeros, exact lattice points, one
#: float32 step either side of one, and values at and beyond 2^31
SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0,
                     np.nextafter(np.float32(3), np.float32(0)),
                     np.nextafter(np.float32(3), np.float32(9)), 2.0**31, -2.0**31,
                     2.0**31 - 128, 3e9, -3e9, 1e20, -1e20], np.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype == torch.float32 and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _values(shape, seed: int, lo=-40.0, hi=40.0) -> torch.Tensor:
    """Seeded float32 coordinates with SPECIALS seeded in."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(lo, hi, shape).astype(np.float32).reshape(-1)
    at = rs.choice(v.size, min(v.size, len(SPECIALS)), replace=False)
    v[at] = SPECIALS[:len(at)]
    return torch.from_numpy(v.reshape(shape))


def _equals_the_reference(got, x, y, z):
    """`got` against the JAX package's NumPy perlin3 at (x, y, z): NaN where
    it has NaN, every other value bit for bit (signed zeros included)."""
    with np.errstate(invalid="ignore"):
        want = np.asarray(ref_noise.perlin3(np, *(a.numpy() for a in (x, y, z))))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(got.isnan().numpy(), nan)
    np.testing.assert_array_equal(got.numpy()[~nan].view(np.int32), want[~nan].view(np.int32))
    return got


def _the_op_equals_the_reference(x, y, z):
    return _equals_the_reference(B6.perlin3(x, y, z), x, y, z)


@pytest.mark.parametrize("name", sorted(COORDS))
def test_the_cpu_op_is_the_eager_perlin3_bit_for_bit(name):
    x, y, z = (torch.from_numpy(a) for a in COORDS[name].astype(np.float32))
    _the_op_equals_the_reference(x, y, z)


def _tile(seed):
    """A strided tile of a larger plane, as render_tiled slices one."""
    return _values((3 * H, 2 * W + 3), seed)[H:2 * H, 3:2 * W + 3:2]


#: (x, y, z) as the evaluator may hand them to a `noise` call, and the
#: broadcast shape
LAYOUTS = {
    "planes": (lambda: (_values((H, W), 1), _values((H, W), 2), _values((H, W), 3)), (H, W)),
    "0-d z": (lambda: (_values((H, W), 1), _values((H, W), 2), _values((), 3)), (H, W)),
    "0-d": (lambda: (_values((), 1), _values((), 2), _values((), 3)), ()),
    "row and column": (lambda: (_values((1, W), 1), _values((H, 1), 2), _values((), 3)),
                       (H, W)),
    "stride 0": (lambda: (_values((W,), 1).expand(H, W), _values((H, 1), 2).expand(H, W),
                          torch.tensor(0.5).expand(H, W)), (H, W)),
    "tile slice": (lambda: (_tile(1), _tile(2), _tile(3)), (H, W)),
    "batch": (lambda: (_values((3, H, W), 1), _values((H, W), 2),
                       _values((3, 1, 1), 3)), (3, H, W)),
    "specials": (lambda: tuple(torch.from_numpy(np.roll(np.resize(SPECIALS, (H, W)), k, 1))
                               for k in (0, 5, 11)), (H, W)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_cpu_op_equals_the_eager_perlin3_on_every_layout(layout):
    make, shape = LAYOUTS[layout]
    got = _the_op_equals_the_reference(*make())
    assert tuple(got.shape) == shape


def test_the_layouts_hold_nan_infinities_signed_zero_and_large_values():
    x, y, z = LAYOUTS["specials"][0]()
    got = B6.perlin3(x, y, z)
    assert bool(got.isnan().any()) and bool(torch.isfinite(got).any())
    big = x.abs() >= 2**31
    assert bool((big & torch.isfinite(x)).any()) and bool((x.isnan()).any())
    assert bool(((x == 0) & x.signbit()).any())


@pytest.mark.parametrize("shapes,want", [
    (((5, 1, 7), (4, 1), ()), (5, 4, 7)),
    (((), (), ()), ()),
    (((1, 12), (8, 1), (1,)), (8, 12)),
])
def test_the_fake_implementation_gives_the_broadcast_shape(shapes, want):
    with FakeTensorMode():
        args = [torch.empty(s, dtype=torch.float32) for s in shapes]
        out = torch.ops.mathmap.perlin3(*args)
    assert tuple(out.shape) == want and out.dtype == torch.float32


def test_opcheck_holds_the_op_to_its_schema_and_fake():
    rs = np.random.RandomState(7)
    x, y, z = (torch.from_numpy(rs.uniform(-40, 40, s).astype(np.float32))
               for s in ((H, W), (1, W), ()))
    torch.library.opcheck(torch.ops.mathmap.perlin3.default, (x, y, z))


def _planes(*shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in shapes]


#: (x, y, z) that the launch refuses
REFUSED = {
    "cpu": lambda: _planes((H, W), (H, W), ()),
    "rank 4": lambda: _planes((2, 2, H, W), (H, W), ()),
    "rank 4 by broadcasting": lambda: _planes((2, 1, 1, 1), (H, W), ()),
    "float64": lambda: _planes((H, W), (H, W), (), dtype=torch.float64),
    "int32": lambda: _planes((H, W), (H, W), (), dtype=torch.int32),
    "not broadcastable": lambda: _planes((H, W), (H, W + 1), ()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_launch_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="perlin3 takes"):
        B6._launch(*REFUSED[case]())


#: a (rows, row stride) output's pointer offset in floats -> whether the
#: launch stores 4 points at once
WIDE_CASES = {"aligned": (0, 3840, True), "ragged width": (0, 1919, False),
              "width 4": (0, 4, True), "one float in": (1, 3840, False),
              "four floats in": (4, 3840, True), "width 6": (0, 6, False)}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_stores_take_aligned_outputs_and_rows(case):
    offset, w, wide = WIDE_CASES[case]
    assert B6.wide_stores(4096 + 4 * offset, 4 * w) is wide


def _call_noise(x, y, z):
    """The `noise` builtin on three scalar values -> (result, counters)."""
    before = snapshot()
    out = N._noise(None, [TupleValue(NIL, (a,)) for a in (x, y, z)], None)
    return out.arrays[0], since(before)["counters"]


def test_a_call_on_the_kernel_route_counts_its_points():
    """On the card the builtin calls the op and counts its points twice:
    `noise.points` and `noise.kernel_points` (fake CUDA tensors, which the
    op's fake implementation evaluates)."""
    with FakeTensorMode():
        x, y, z = (torch.empty(s, device="cuda") for s in ((1, W), (H, 1), ()))
        got, counters = _call_noise(x, y, z)
    assert got.is_cuda and tuple(got.shape) == (H, W) and got.dtype == torch.float32
    assert counters.get("noise.points") == counters.get("noise.kernel_points") == H * W


@pytest.mark.parametrize("case", ["float64", "rank 4"])
def test_a_call_the_kernel_does_not_take_stays_eager_and_counts(case):
    """On the CPU the op's plain version evaluates what the launch would
    refuse on the card."""
    if case == "float64":
        x, y, z = (a.double() for a in LAYOUTS["0-d z"][0]())
    else:
        x, y, z = _values((2, 2, H, W), 1), _values((H, W), 2), _values((), 3)
    got, counters = _call_noise(x, y, z)
    assert got.dtype == x.dtype and tuple(got.shape) == tuple(x.shape)
    with np.errstate(invalid="ignore"):
        want = ref_noise.perlin3(np, x.numpy(), y.numpy(), z.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert counters.get("noise.points") == got.numel()
    assert "noise.kernel_points" not in counters


def test_the_cpu_keeps_the_eager_route_and_counts_nothing_else():
    x, y, z = LAYOUTS["0-d z"][0]()
    got, counters = _call_noise(x, y, z)
    assert _same_bits(got, B6.perlin3_reference(x, y, z))
    assert counters.get("noise.points") == H * W
    assert "noise.kernel_points" not in counters


#: library filters whose noise calls take both layouts: full planes with a
#: 0-d z (turbulence, voronoi's cells) and rows, columns and constants
#: (marble, wood); (calls a frame after the first, the frame's size: from
#: then on voronoi's loops find their probes' outcomes in their memos, 18
#: calls where the first frame makes 32)
RENDERS = {"turbulence": 4, "voronoi": 18, "marble": None, "wood": None}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_a_batch_of_noise_renders_equals_its_lone_renders(name):
    """A batch's noise calls take (job, H, W) coordinates where a lone
    render's take (H, W): each job equals its lone render bit for bit, and
    the points counted are those of the lone renders."""
    f = _library_filter(name)
    kw = dict(width=40, height=24, device="cpu")
    f.render(t=0.9, **kw)
    before = snapshot()
    lone = [f.render(t=t, **kw) for t in (0.1, 0.6)]
    points = since(before)["counters"]["noise.points"]
    before = snapshot()
    batch = f.render_batch(ts=[0.1, 0.6], **kw)
    counters = since(before)["counters"]
    assert torch.equal(batch, torch.stack(lone))
    assert counters["noise.points"] == points and "noise.kernel_points" not in counters
    if RENDERS[name] is not None:
        assert points == 2 * RENDERS[name] * 40 * 24


def test_the_float64_spec_stays_eager():
    f = _library_filter("turbulence")
    before = snapshot()
    out = f.render(width=20, height=12, t=0.3, interpret=True, precision="f64")
    counters = since(before)["counters"]
    assert out.dtype == torch.float64
    assert counters["noise.points"] == 4 * 20 * 12 and "noise.kernel_points" not in counters


def _perlin3_nodes(art) -> int:
    """The `mathmap::perlin3` calls in an artifact's program, its
    submodules (a `while_loop` body) included."""
    return sum(str(n.target) == "mathmap.perlin3.default"
               for m in art._program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes)


def test_an_artifact_holds_the_noise_op_and_renders_equal(tmp_path):
    """Exported on the CPU, turbulence's program calls
    `mathmap::perlin3` four times (its fake implementation traced it) and
    holds no Perlin table; it renders equal to the live render bit for bit
    at new param values and times."""
    f = _library_filter("turbulence")
    path = tmp_path / "turbulence.mmxa"
    export_artifact(f, str(path), 40, 24, params={"scale": 80.0, "gain": 0.5},
                    device="cpu")
    art = load_artifact(str(path))
    assert _perlin3_nodes(art) == 4
    assert not any("index" in str(n.target) for n in art._program.graph.nodes)
    for t, p in ((0.3, {"scale": 80.0, "gain": 0.5}), (0.8, {"scale": 37.0, "gain": 0.7})):
        want = f.render(width=40, height=24, t=t, params=p, device="cpu")
        assert torch.equal(art.render(t=t, params=p), want)


def test_an_exported_loop_body_holds_the_noise_op(tmp_path):
    """ridged_noise with `octaves` as a runtime input exports its octave
    loop as torch's `while_loop` op: the body graph calls
    `mathmap::perlin3`, and the artifact renders equal to the live render
    at other octave counts."""
    f = _library_filter("ridged_noise")
    path = tmp_path / "ridged.mmxa"
    export_artifact(f, str(path), 24, 16, params={"octaves": 3}, device="cpu")
    art = load_artifact(str(path))
    assert any(n.target is torch.ops.higher_order.while_loop
               for n in art._program.graph.nodes)
    assert _perlin3_nodes(art) >= 1
    for octaves in (1, 5):
        want = f.render(width=24, height=16, t=0.3, params={"octaves": octaves},
                        device="cpu")
        assert torch.equal(art.render(t=0.3, params={"octaves": octaves}), want)
