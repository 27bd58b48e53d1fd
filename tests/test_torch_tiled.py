"""The input-sharded render (`Filter.render_tiled`, parallel/halo.py) on CPU
meshes against the JAX package's `render_tiled` on its 8 virtual CPU
devices (which samples through the exact gather route there), and against
the port's own unsharded render.

The cases are tests/test_halo.py's: identity, bounded shift and wave, wrap
seam, reflect and color edges, column-split tiles and their wrap seam,
auto halo and its refusal, a too-small halo (raising with check=True, the
same clamped output as JAX's with check=False), halo 0, a negative halo and
one larger than a tile, multiple inputs, params, uint8 input, sampling
inside a loop and the one-device-axis bottom edge; each on the meshes
(1,8,1), (1,2,4) and (1,1,1). Where the reference raises, the port must
raise the same error. Tolerance rtol=1e-4, atol=1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mathmap_tpu_torch.convert import options_from_reference
from mathmap_tpu_torch.kernels import sample_tiled as B4

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W = 32, 16
RTOL, ATOL = 1e-4, 1e-5
MESHES = ((1, 8, 1), (1, 2, 4), (1, 1, 1))


def _image(seed, h=H, w=W):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _u8(seed, h=H, w=W):
    return (np.random.RandomState(seed).rand(h, w, 4) * 255).astype(np.uint8)


def ref_mesh(shape):
    n = int(np.prod(shape))
    return ref_make_mesh(*shape, devices=jax.devices()[:n])


def port_mesh(shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


BLEND2 = ("filter blend2 (image p, image q) "
          "p(xy + xy:[0, 2*sin(x/7)]) * 0.6 + "
          "q(xy + xy:[3*sin(y/9), 0]) * 0.4 end")
LOOP = ("s = 0; i = 0; while i < 3 do "
        "s = s + red(origVal(xy + xy:[0, i])); i = i + 1 end; "
        "grayColor(s / 3)")
WAVE = "origVal(xy + xy:[0, 2 * sin(x / 3 + t)])"

#: name -> (source or .mm path, halo, option fields, extra render kwargs,
#: input maker)
CASES = {
    "identity": ("origVal(xy)", 1, {}, {}, "f32"),
    "bounded_shift": ("origVal(xy + xy:[0, 2])", 3, {}, {}, "f32"),
    "wave": (WAVE, 4, {}, dict(t=0.41), "f32"),
    "wave_bicubic": (WAVE, 4, dict(interpolation="bicubic"), dict(t=0.41), "f32"),
    "wave_supersample": (WAVE, 4, dict(supersample=2), dict(t=0.41), "f32"),
    "wave_uint8_output": (WAVE, 4, dict(output_dtype="uint8"), dict(t=0.41), "f32"),
    "horizontal_access": ("origVal(xy + xy:[7 * sin(y / 5), 1])", 2, {}, {}, "f32"),
    "wrap_seam": ("origVal(xy + xy:[0, 3])", 3, dict(edge_x="wrap", edge_y="wrap"), {}, "f32"),
    "reflect": ("origVal(xy + xy:[0, 2])", 3, dict(edge_y="reflect"), {}, "f32"),
    "color_edge": ("origVal(xy + xy:[0, 3])", 4, dict(edge_color=(0.2, 0.4, 0.6, 1.0)), {},
                   "f32"),
    "column_sharded": ("origVal(xy + xy:[2 * sin(y / 4), 2 * sin(x / 3)])", "auto", {}, {},
                       "f32"),
    "column_wrap_seam": ("origVal(xy + xy:[3, 2])", (3, 4), dict(edge_x="wrap", edge_y="wrap"),
                         {}, "f32"),
    "auto_halo": (WAVE, "auto", {}, dict(t=0.41), "f32"),
    "auto_halo_unbounded": ("origVal(xy * xy)", "auto", {}, {}, "f32"),
    "auto_halo_flip": ("origValXY(-x, y)", "auto", dict(interpolation="nearest"), {}, "f32"),
    "auto_halo_origval_image": ("filter g (image in) origValImage(in, xy + xy:[0, 2]) end",
                                "auto", dict(interpolation="nearest"), {}, "f32"),
    "auto_halo_alias": ("filter f (image in) q = in; q(xy + xy:[0, 2]) end", "auto", {}, {},
                        "f32"),
    "too_small_halo": ("origVal(xy + xy:[0, 3])", 1, {}, {}, "f32"),
    "too_small_halo_unchecked": ("origVal(xy + xy:[0, 3])", 1, {}, dict(check=False), "f32"),
    "far_out_unchecked": ("origVal(xy + xy:[0, 40])", 4, {}, dict(check=False), "f32"),
    "below_block_color_unchecked": ("origVal(xy + xy:[0, -12])", 4,
                                    dict(edge_color=(0.9, 0.1, 0.5, 1.0)),
                                    dict(check=False), "f32"),
    "halo_zero": ("origVal(xy)", 0, dict(interpolation="nearest"), {}, "f32"),
    "halo_negative": ("origVal(xy)", -1, {}, {}, "f32"),
    "halo_larger_than_tile": ("origVal(xy)", 5, {}, {}, "f32"),
    "multi_input": (BLEND2, "auto", {}, {}, "two"),
    "params": ("filters/Distorts/ripple.mm", "auto", {}, dict(params={"amplitude": 1.0}),
               "f32"),
    "uint8_input": ("filter f (image in) in(xy + xy:[2, -1]) end", "auto",
                    dict(interpolation="bilinear", edge_x="wrap", edge_y="reflect"), {}, "u8"),
    "sampling_inside_loop": (LOOP, 3, {}, {}, "f32"),
}


def _inputs(kind):
    if kind == "two":
        return [_image(70), _image(71)]
    return [_u8(44) if kind == "u8" else _image(9)]


def _compile(pkg, src):
    if src.endswith(".mm"):
        return pkg.compile_file(os.path.join(ROOT, src))
    return (mm.compile if pkg is mm else mt.compile_source)(src)


def _render_both(src, halo, opt_fields, kw, inputs, mesh_shape):
    """The reference's render_tiled and the port's on the same inputs ->
    (reference result or its exception, port result or its exception)."""
    ro = mm.RenderOptions(**opt_fields)
    try:
        want = np.asarray(_compile(mm, src).render_tiled(
            *inputs, halo=halo, mesh=ref_mesh(mesh_shape), options=ro, **kw))
    except (mm.MMError, ValueError) as e:
        want = e
    try:
        got = _compile(mt, src).render_tiled(
            *inputs, halo=halo, mesh=port_mesh(mesh_shape),
            options=options_from_reference(ro), **kw)
    except (mt.MMError, ValueError) as e:
        got = e
    return want, got


def _assert_parity(want, got):
    if isinstance(want, Exception):
        assert isinstance(got, Exception), f"the reference raised {want!r}, the port did not"
        assert type(got).__name__ == type(want).__name__, (want, got)
        return
    assert not isinstance(got, Exception), got
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == (torch.uint8 if want.dtype == np.uint8 else torch.float32)
    if want.dtype == np.uint8:
        assert int(np.abs(got.numpy().astype(int) - want.astype(int)).max()) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_tiled_matches_the_reference(case, mesh_shape):
    src, halo, opt_fields, kw, kind = CASES[case]
    want, got = _render_both(src, halo, opt_fields, kw, _inputs(kind), mesh_shape)
    _assert_parity(want, got)


EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))


@pytest.mark.parametrize("ex,ey", EDGE_PAIRS)
@pytest.mark.parametrize("interp", ("nearest", "bilinear", "bicubic"))
@pytest.mark.parametrize("mesh_shape", MESHES[:2], ids=lambda s: "x".join(map(str, s)))
def test_render_tiled_every_interpolation_and_edge_pair(mesh_shape, interp, ex, ey):
    src = "origVal(xy + xy:[1.5 * sin(y / 4), 1.5 * cos(x / 3 + t)])"
    want, got = _render_both(src, (4, 4), dict(interpolation=interp, edge_x=ex, edge_y=ey,
                                                edge_color=(0.25, 0.5, 0.75, 1.0)),
                             dict(t=0.3), [_image(12)], mesh_shape)
    _assert_parity(want, got)


@pytest.mark.parametrize("edges", [("wrap", "reflect"), ("reflect", "reflect"),
                                   ("color", "color"), ("wrap", "wrap")])
def test_one_device_axis_bottom_edge(edges):
    """A 1-tile row axis still carries the interpolation-margin halo; bottom
    rows displaced past the global edge read content rows, not the
    (repainted) lead halo."""
    ex, ey = edges
    src = "origVal(xy + xy:[6 * sin(y / 19), 5 * cos(x / 23 + t)])"
    img = _image(40, 64, 128)
    want, got = _render_both(src, 8, dict(edge_x=ex, edge_y=ey), dict(t=0.3), [img], (1, 1, 1))
    _assert_parity(want, got)


def test_check_raises_the_port_error_and_names_the_halo():
    f = mt.compile_source("origVal(xy + xy:[0, 3])")
    with pytest.raises(mt.MMRuntimeError, match="bounded-displacement contract"):
        f.render_tiled(_image(9), halo=1, mesh=port_mesh((1, 8, 1)))


def test_tiled_render_equals_the_unsharded_render_and_runs_no_kernel_on_the_cpu():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "pond.mm"))
    img = _u8(3, 128, 96)  # 32-row tiles hold pond's auto halo of 27 rows
    before = B4.sample_tiled.launches
    got = f.render_tiled(img, mesh=port_mesh((1, 4, 1)))
    assert B4.sample_tiled.launches == before
    np.testing.assert_array_equal(got.numpy(), f.render(img, device="cpu").numpy())


def test_a_render_with_a_loop_sample_past_the_halo_is_not_checked():
    """Samples inside a while loop are not measured (the reference's
    loop_depth gate): check=True renders, and clamps like check=False."""
    src = ("s = 0; i = 0; while i < 2 do "
           "s = s + red(origVal(xy + xy:[0, 6])); i = i + 1 end; grayColor(s / 2)")
    f = mt.compile_source(src)
    mesh = port_mesh((1, 8, 1))
    a = f.render_tiled(_image(9), halo=2, mesh=mesh)
    b = f.render_tiled(_image(9), halo=2, mesh=mesh, check=False)
    assert torch.equal(a, b)


def test_tiled_inputs_must_share_the_output_geometry():
    f = mt.compile_source("filter g (image p, image q) p(xy) + q(xy) end")
    with pytest.raises(ValueError, match="share the output geometry"):
        f.render_tiled(_image(1), _image(2, H // 2, W), halo=2, mesh=port_mesh((1, 8, 1)))


def test_unknown_param_name_raises():
    f = mt.compile_file(os.path.join(ROOT, "filters", "Distorts", "ripple.mm"))
    with pytest.raises(ValueError, match="nope"):
        f.render_tiled(_image(1), halo=2, mesh=port_mesh((1, 8, 1)), params={"nope": 1.0})


def test_exchange_halo_wraps_the_ring():
    from mathmap_tpu_torch.parallel.halo import exchange_halo

    blocks = [torch.full((2, 3, 4), float(i)) for i in range(3)]
    ext = exchange_halo(blocks, 1, axis=0)
    assert [tuple(e[:, 0, 0].tolist()) for e in ext] == [(2, 0, 0, 1), (0, 1, 1, 2), (1, 2, 2, 0)]
    assert exchange_halo(blocks, 0) == blocks
    with pytest.raises(mt.MMRuntimeError, match=">= 0"):
        exchange_halo(blocks, -1)
