"""convert.py: the reference's RenderOptions, input images and params carried
across to the port."""

import dataclasses

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.imgio.images import to_float_rgba
from mathmap_tpu_torch.convert import (inputs_from_numpy, options_from_reference,
                                       params_from_reference)
from mathmap_tpu_torch.kernels.sample_image import u8_to_float

#: one valid non-default value for every field of the reference RenderOptions
NON_DEFAULT = {
    "interpolation": "bicubic",
    "edge_x": "wrap",
    "edge_y": "reflect",
    "edge_color": (0.1, 0.2, 0.3, 0.4),
    "supersample": 3,
    "supersample_scheme": "corners",
    "output_dtype": "uint8",
    "region": (1, 2, 3, 4),
    "max_loop_iters": 77,
    "pallas_while": "off",
    "while_unroll": 2,
    "while_static_unroll": 5,
    "periodic": False,
    "seed": 9,
    "static_params": ("angle",),
    "sampler": "gather",
    "pallas_tiers": ((8, 64, 32, 256, 0),),
    "pallas_per_tile": "on",
    "sweep_unroll": 4,
    "pallas_precision": "f32",
}
UNPORTED_FIELDS = {"region", "supersample_scheme"}
REF_FIELDS = [f.name for f in dataclasses.fields(mm.RenderOptions)]


def test_table_covers_every_reference_field():
    assert set(NON_DEFAULT) == set(REF_FIELDS)
    assert REF_FIELDS == [f.name for f in dataclasses.fields(mt.RenderOptions)]


@pytest.mark.parametrize("field", REF_FIELDS)
def test_options_from_reference_carries_each_field(field):
    ref = mm.RenderOptions(**{field: NON_DEFAULT[field]})
    if field in UNPORTED_FIELDS:
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            options_from_reference(ref)
        return
    port = options_from_reference(ref)
    assert isinstance(port, mt.RenderOptions)
    for name in REF_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


def test_options_from_reference_defaults_are_equal():
    assert dataclasses.asdict(options_from_reference(mm.RenderOptions())) \
        == dataclasses.asdict(mm.RenderOptions())


def test_options_with_an_unknown_field_raise():
    @dataclasses.dataclass(frozen=True)
    class Newer(mm.RenderOptions):
        turbo: bool = True

    with pytest.raises(ValueError, match="turbo"):
        options_from_reference(Newer())


def test_u8_rgba_stays_u8():
    img = np.random.RandomState(0).randint(0, 256, (5, 6, 4)).astype(np.uint8)
    (t,) = inputs_from_numpy([img], "cpu")
    assert t.dtype == torch.uint8 and t.shape == (5, 6, 4)
    assert np.array_equal(t.numpy(), img)


@pytest.mark.parametrize("shape", [(5, 6), (5, 6, 1), (5, 6, 3), (5, 6, 4)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_expansion_matches_to_float_rgba(shape, dtype):
    rs = np.random.RandomState(1)
    img = (rs.randint(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else rs.rand(*shape).astype(dtype))
    (t,) = inputs_from_numpy([img], torch.device("cpu"))
    assert t.shape == (5, 6, 4)
    assert t.dtype == (torch.uint8 if dtype == np.uint8 else torch.float32)
    got = u8_to_float(t) if t.dtype == torch.uint8 else t
    # the reference's native u8 path multiplies by 1/255 where the port
    # divides (render.float_inputs' rule): at most 1 ulp apart
    np.testing.assert_allclose(got.numpy(), to_float_rgba(img), rtol=1e-7, atol=0)


def test_bad_channel_count_raises():
    with pytest.raises(ValueError, match="channels"):
        inputs_from_numpy([np.zeros((4, 4, 2), np.float32)], "cpu")


def test_rgb_u8_input_renders_like_the_reference():
    img = np.random.RandomState(3).randint(0, 256, (16, 20, 3)).astype(np.uint8)
    path = "filters/Distorts/twirl.mm"
    ref = mm.compile_file(path).render(img, t=0.3, interpret=True)
    got = mt.compile_file(path).render(img, t=0.3, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_params_pass_through_validated():
    out = params_from_reference({"a": 1, "b": np.float32(0.5), "c": True,
                                 "d": (0.1, 0.2, 0.3), "e": [1, 0, 0, 1]})
    assert out == {"a": 1.0, "b": 0.5, "c": True, "d": (0.1, 0.2, 0.3),
                   "e": (1.0, 0.0, 0.0, 1.0)}
    assert isinstance(out["b"], float)


@pytest.mark.parametrize("value", [np.zeros((4, 4, 5)), "red", (0.1, 0.2), lambda x: x])
def test_unported_param_values_raise(value):
    with pytest.raises(TypeError):
        params_from_reference({"p": value})
