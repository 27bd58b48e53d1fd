"""Mirror of the CPU-meaningful cases of tests/test_uint8_io.py on the
port: uint8 output packed in the render (`RenderOptions(output_dtype=
'uint8')`, kernels/finish_rgba.pack_uint8) bit for bit the host helpers'
(imgio.images.to_uint8), uint8 inputs converted by the one rule
(kernels/sample_image.u8_to_float) on every path, and meshes given as
`devices=["cpu"] * n`. Each render is the port's CPU route, held against
the reference's `render(..., interpret=True)` at rtol=1e-4, atol=1e-5, or
within one level for uint8 output (tests/_torch_shim.py), beside the
reference test's own claim.

Held to the oracle instead of the reference's claim:

- test_u8_input_matches_host_converted_f32_bitwise and
  test_animated_u8_input_matches_f32 claim that a u8 input renders bit for
  bit like its to_float_rgba twin on the jit path. The reference's own
  oracle breaks that claim (_WARP: 1191 of 3072 values differ, by up to
  1.19e-7), so here the port's u8 render and its f32 twin each equal the
  oracle's render of the same input bit for bit.

Left out, with the reason:

- test_exact_u8_eligibility_rules: the TPU sampler's bf16 pad plan
  (`exact_u8_eligible`, `image_pad_plan`); the port's sampler reads u8
  taps directly (tests/test_torch_sampler_design.py holds its exact
  conversion).
- test_exact_u8_image_userval_param's `_userval_pytree` half: the jit
  cache's static kinds spec; its render half is mirrored.
- test_sweep_unroll_option's `sweep_unroll_for`: the reference's lax.map
  chunking; the option's validation and the sweep's equality with
  per-frame renders are mirrored.
"""

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from _torch_shim import assert_matches_oracle
from mathmap_tpu.imgio.images import to_uint8 as ref_to_uint8
from mathmap_tpu_torch.kernels.sample_image import u8_to_float
from mathmap_tpu_torch.kernels.finish_rgba import pack_uint8

H, W = 24, 32

_WARP = "filter w (image in) in(xy + [sin(y/5)*2, cos(x/7)*2]) end"
_TWIST = "filter tw (image in) in(xy + [sin(y/3)*4, cos(x/5)*4]) end"


def _img_f32(seed=3, h=H, w=W):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _img_u8(seed=3, h=H, w=W):
    return np.random.RandomState(seed).randint(0, 256, size=(h, w, 4), dtype=np.uint8)


def _render(src, *inputs, **kw):
    """The port's CPU render as numpy, held against the oracle."""
    opts = kw.pop("options", None)
    out = mt.compile_source(src).render(*inputs, interpret=True, options=opts, **kw).numpy()
    ref_opts = mm.RenderOptions(**vars(opts)) if opts is not None else None
    oracle = mm.compile_source(src).render(*inputs, interpret=True, options=ref_opts, **kw)
    assert_matches_oracle(out, np.asarray(oracle), src)
    return out, np.asarray(oracle)


def _mesh(rows, cols=1):
    return mt.make_mesh(1, rows, cols, devices=["cpu"] * (rows * cols))


def test_output_dtype_validation():
    with pytest.raises(ValueError, match="output_dtype"):
        mt.RenderOptions(output_dtype="float16")


def test_pack_matches_host_pack_bitwise():
    img = _img_f32()
    f32, _ = _render(_WARP, img)
    u8, _ = _render(_WARP, img, options=mt.RenderOptions(output_dtype="uint8"))
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, mt.to_uint8(f32))


def test_pack_formula_ties_and_bounds():
    vals = np.concatenate([
        np.arange(256, dtype=np.float32) / 255.0,
        np.float32([-.5, -1e-6, 0.0, 1.0, 1.0 + 1e-6, 2.0]),
        (np.arange(255, dtype=np.float32) + 0.5) / 255.0,
        np.random.RandomState(0).rand(512).astype(np.float32),
    ])
    dev = pack_uint8(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(dev, mt.to_uint8(vals))
    np.testing.assert_array_equal(dev, ref_to_uint8(vals))


@pytest.mark.parametrize("src,interp", [(_WARP, "bilinear"),
                                        ("filter a (image in) origValXY(x, y, 1) end",
                                         "nearest")])
def test_u8_input_and_its_f32_twin_each_equal_the_oracle(src, interp):
    """The two u8 bitwise claims, held to the oracle: a u8 input (single
    or animated) and its to_float_rgba twin each render bit for bit as the
    oracle renders them."""
    shape = (H, W, 4) if interp == "bilinear" else (3, H, W, 4)
    raw = np.random.RandomState(9).randint(0, 256, size=shape, dtype=np.uint8)
    twin = np.stack([mt.to_float_rgba(f) for f in raw.reshape(-1, H, W, 4)]).reshape(shape)
    opts = mt.RenderOptions(interpolation=interp)
    for arr in (raw, twin):
        out, oracle = _render(src, arr, options=opts)
        np.testing.assert_array_equal(out, oracle)


def test_u8_in_u8_out_matches_oracle():
    out, oracle = _render(_WARP, _img_u8(5), options=mt.RenderOptions(output_dtype="uint8"))
    assert out.dtype == oracle.dtype == np.uint8


def test_u8_output_sampler_options_are_one_route():
    """sampler='pallas' and 'gather' name TPU routes; the port accepts
    them and renders the same pixels either way."""
    img = _img_f32(7, 64, 96)
    a, _ = _render(_WARP, img, options=mt.RenderOptions(
        output_dtype="uint8", sampler="pallas", pallas_precision="f32"))
    b, _ = _render(_WARP, img, options=mt.RenderOptions(output_dtype="uint8",
                                                        sampler="gather"))
    np.testing.assert_array_equal(a, b)


def test_render_batch_tensor_stack_passes_through():
    f = mt.compile_source(_WARP)
    frames = np.stack([_img_f32(s) for s in range(4)])
    outs = f.render_batch(torch.from_numpy(frames), ts=[0.0] * 4, frames=[0.0] * 4,
                          device="cpu")
    for i in range(4):
        one, _ = _render(_WARP, frames[i])
        np.testing.assert_array_equal(outs[i].numpy(), one)


def test_render_batch_u8_stack_and_u8_out():
    f = mt.compile_source(_WARP)
    raw = np.random.RandomState(11).randint(0, 256, size=(3, H, W, 4), dtype=np.uint8)
    opts = mt.RenderOptions(output_dtype="uint8")
    outs = f.render_batch(raw, ts=[0.0] * 3, frames=[0.0] * 3, options=opts, device="cpu")
    assert outs.dtype == torch.uint8
    for i in range(3):
        one, _ = _render(_WARP, raw[i], options=opts)
        np.testing.assert_array_equal(outs[i].numpy(), one)


def test_sharded_u8_output_matches_unsharded():
    img = _img_f32(13, 32, 48)
    opts = mt.RenderOptions(output_dtype="uint8")
    sh = mt.compile_source(_WARP).render_sharded(img, options=opts, mesh=_mesh(8))
    un, _ = _render(_WARP, img, options=opts)
    assert sh.dtype == torch.uint8
    np.testing.assert_array_equal(sh.numpy(), un)


def test_tiled_u8_output_matches_plain():
    img = _img_f32(17, 32, 48)
    opts = mt.RenderOptions(output_dtype="uint8")
    ti = mt.compile_source(_WARP).render_tiled(img, options=opts, mesh=_mesh(8))
    un, _ = _render(_WARP, img, options=opts)
    assert ti.dtype == torch.uint8
    np.testing.assert_array_equal(ti.numpy(), un)


def test_corners_supersample_u8():
    img = _img_f32(19)
    u8, _ = _render(_WARP, img, options=mt.RenderOptions(
        supersample=2, supersample_scheme="corners", output_dtype="uint8"))
    f32, _ = _render(_WARP, img, options=mt.RenderOptions(supersample=2,
                                                          supersample_scheme="corners"))
    np.testing.assert_array_equal(u8, mt.to_uint8(f32))


def test_to_uint8_passthrough_and_read_animation_u8(tmp_path):
    raw = _img_u8(23)
    assert mt.to_uint8(raw) is raw
    from PIL import Image

    from mathmap_tpu_torch.imgio.images import read_animation

    p = tmp_path / "a.gif"
    Image.fromarray(raw).save(p)
    stack = read_animation(str(p), as_uint8=True)
    assert stack.dtype == np.uint8 and stack.shape == (1, H, W, 4)


def test_u8_conversion_round_trip_recovers_all_values():
    """round(u8_to_float(u) * 255) == u for every u8 value: the port's one
    conversion rule (the reference's exact-u8 pad property)."""
    u = torch.arange(256, dtype=torch.uint8)
    v = u8_to_float(u)
    np.testing.assert_array_equal(torch.round(v * 255.0).numpy(), u.numpy().astype(np.float32))
    np.testing.assert_array_equal(v.numpy(), u.numpy().astype(np.float32) / np.float32(255.0))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
def test_u8_input_matches_oracle_every_interpolation(prec, interp):
    """u8 input under every interpolation, wrap/reflect edges; the
    reference's Pallas precision options are accepted and change nothing."""
    opts = mt.RenderOptions(interpolation=interp, edge_x="wrap", edge_y="reflect",
                            sampler="pallas", pallas_precision=prec, pallas_per_tile="on")
    _render(_TWIST, _img_u8(7, 64, 96), options=opts)


@pytest.mark.parametrize("edge_color", [(0.0, 128.0 / 255.0, 1.0, 1.0),
                                        (0.1234, 0.0, 0.5, 1.0)])
def test_u8_input_color_edge_matches_oracle(edge_color):
    """'color' edges on a u8 input, on and off the u8 grid."""
    opts = mt.RenderOptions(edge_x="color", edge_y="color", edge_color=edge_color,
                            sampler="pallas", pallas_precision="f32")
    _render("filter z (image in) in(xy*1.4 - [8, 8]) end", _img_u8(11, 48, 64), options=opts)


def test_u8_tensor_input_matches_oracle():
    img = _img_u8(5, 64, 96)
    out = mt.compile_source(_TWIST).render(torch.from_numpy(img), interpret=True).numpy()
    assert_matches_oracle(out, mm.compile_source(_TWIST).render(img, interpret=True))


def test_u8_image_param_matches_oracle():
    src = ("filter m (image in, image other)\n"
           "  other(xy + [sin(y/4)*3, 0])\nend")
    _render(src, _img_u8(2, 48, 64), params={"other": _img_u8(9, 48, 64)})


def test_sweep_unroll_option():
    with pytest.raises(ValueError, match="sweep_unroll"):
        mt.RenderOptions(sweep_unroll=0)
    with pytest.raises(ValueError, match="sweep_unroll"):
        mt.RenderOptions(sweep_unroll="always")
    src = ("filter r (image in, float amp: 0-10 (2))\n"
           "  in(xy + [sin(y/6 + t*6)*amp, 0])\nend")
    f = mt.compile_source(src)
    img = _img_f32(0, 40, 64)
    for u in ("auto", 1, 3, 8):
        opts = mt.RenderOptions(sweep_unroll=u)
        anim = f.render_animation(img, num_frames=7, options=opts, device="cpu").numpy()
        per = np.stack([_render(src, img, t=i / 7, frame=i,
                                options=opts)[0] for i in range(7)])
        np.testing.assert_array_equal(anim, per)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_sharded_u8_input_matches_unsharded_bitwise(prec):
    img = _img_u8(21, 32, 48)
    opts = mt.RenderOptions(sampler="pallas", pallas_precision=prec)
    sh = mt.compile_source(_WARP).render_sharded(img, options=opts, mesh=_mesh(8))
    un, _ = _render(_WARP, img, options=opts)
    np.testing.assert_array_equal(sh.numpy(), un)


def test_tiled_u8_input_identity_and_warp():
    """u8 inputs through render_tiled: the identity render reproduces u/255
    exactly, and the warp equals the plain render on wrap and on-grid
    color edges."""
    img = _img_u8(29, 32, 48)
    ident = mt.compile_source("filter i (image in) in(xy) end")
    ti = ident.render_tiled(img, width=48, height=32, mesh=_mesh(8))
    np.testing.assert_array_equal(ti.numpy(), img.astype(np.float32) / np.float32(255.0))
    f = mt.compile_source(_WARP)
    for ex, ey in (("wrap", "wrap"), ("color", "color")):
        o = mt.RenderOptions(edge_x=ex, edge_y=ey, edge_color=(0.0, 128 / 255.0, 1.0, 1.0))
        ti = f.render_tiled(img, options=o, mesh=_mesh(4, 2))
        un, _ = _render(_WARP, img, options=o)
        np.testing.assert_allclose(ti.numpy(), un, atol=1e-6)
