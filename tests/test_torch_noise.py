"""Perlin noise through the port on the CPU, against the JAX package's NumPy
`perlin3` and oracle (`interpret=True`):

- `perlin3` bit for bit on negative, lattice (integer), large (|x| above
  2^24 and 2^31) and random coordinates, and on NaN and infinite ones;
- the lattice index against NumPy's `astype(int32) & 255` there;
- the `noise` builtin's two forms and its errors;
- the library entries that call noise (camo, caustics, clouds, hex_grid,
  lava, marble, ridged_noise, rust, turbulence, voronoi, warp_noise, wood)
  at 64x48 at two seeds and with supersample=2, rtol=1e-4, atol=1e-5;
- the loops that call noise (ridged_noise's octaves, voronoi's 3x3 scan)
  never take kernel B3 (noise is not one of its builtins);
- fault C4: exports of a noise filter leave the table's cache real.
"""

import numpy as np
import pytest
import torch

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.ops import noise as ref_noise
from mathmap_tpu_torch.ops import noise as N
from test_torch_rand import RENDER_CASES, render_against_oracle
from test_torch_render import _library_filter
from test_torch_while import _routes

RTOL, ATOL = 1e-4, 1e-5

#: coordinate sets, each (n,) float32 per axis
_RS = np.random.RandomState(0)
COORDS = {
    "random": _RS.uniform(-50, 50, (3, 4096)),
    "negative": -_RS.uniform(0, 300, (3, 2048)),
    "lattice": _RS.randint(-600, 600, (3, 2048)).astype(np.float64),
    "near_lattice": (_RS.randint(-40, 40, (3, 2048))
                     + _RS.choice([-1e-6, 0.0, 1e-6, 0.5], (3, 2048))),
    "above_2_24": _RS.choice([-1, 1], (3, 2048)) * _RS.uniform(2**24, 2**30, (3, 2048)),
    "above_2_31": _RS.choice([-1, 1], (3, 1024)) * _RS.uniform(2**31, 2**40, (3, 1024)),
    "mixed_large": np.stack([_RS.uniform(2**31, 2**33, 1024), _RS.uniform(-9, 9, 1024),
                             _RS.uniform(-9, 9, 1024)]),
    "nan_inf": np.stack([np.array([np.nan, np.inf, -np.inf, 0.5, 1.0, 7.25] * 8),
                         np.array([0.3, 0.2, -4.5, np.nan, np.inf, -np.inf] * 8),
                         np.tile([0.1, -0.7, 2.5], 16)]),
}


def _coords(name):
    return COORDS[name].astype(np.float32)


@pytest.mark.parametrize("name", sorted(COORDS))
def test_perlin3_is_the_reference_bit_for_bit(name):
    x, y, z = _coords(name)
    with np.errstate(invalid="ignore"):
        want = ref_noise.perlin3(np, x, y, z)
    got = N.perlin3(*(torch.from_numpy(a) for a in (x, y, z)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_array_equal(got.numpy()[finite].view(np.int32),
                                  want[finite].view(np.int32))


@pytest.mark.parametrize("name", sorted(COORDS))
def test_lattice_index_is_numpys_int32_cast(name):
    f = np.floor(_coords(name)[0])
    with np.errstate(invalid="ignore"):
        want = f.astype(np.int32) & 255
    np.testing.assert_array_equal(N.lattice(torch.from_numpy(f)).numpy(), want)


def test_perlin3_broadcasts_a_scalar_axis():
    x, y, _ = _coords("random")
    z = np.float32(0.3)
    got = N.perlin3(torch.from_numpy(x), torch.from_numpy(y), torch.tensor(z))
    np.testing.assert_array_equal(got.numpy(), ref_noise.perlin3(np, x, y, z))


def test_the_table_is_made_once_per_device():
    t = N.perm_table("cpu")
    assert N.perm_table(torch.device("cpu")) is t
    assert t.dtype == torch.int32 and t.shape == (512,)
    np.testing.assert_array_equal(t.numpy(), ref_noise._PERM_NP)


def test_an_export_leaves_no_traced_table_behind(tmp_path):
    """Fault C4: a Perlin table first asked for under torch.export was a
    tracer's fake tensor, which the per-device cache kept: the next export
    of a noise filter failed and a live render returned a fake tensor. With
    the cache empty (as in a process whose first noise call is an export),
    ridged_noise exports twice, and a live noise render after that is a
    real tensor equal to the one before."""
    from mathmap_tpu_torch.generators.artifact import export_artifact

    turbulence = _library_filter("turbulence")
    before = turbulence.render(width=24, height=16, t=0.3, interpret=True)
    N._table.cache_clear()
    for k in range(2):
        export_artifact(_library_filter("ridged_noise"), str(tmp_path / f"r{k}.mmxa"), 64, 48,
                        device="cpu")
    after = turbulence.render(width=24, height=16, t=0.3, interpret=True)
    assert type(after) is torch.Tensor
    assert torch.equal(after, before)
    assert type(N.perm_table("cpu")) is torch.Tensor


@pytest.mark.parametrize("src", ["grayColor(0.5 + 0.5 * noise([x / 7, y / 5, t]))",
                                 "grayColor(0.5 + 0.5 * noise(x / 7, y / 5, 0.25))",
                                 "grayColor(noise(v3:[x / 3, -y / 4, x * y / 50]))"])
def test_noise_builtin_matches_the_oracle(src):
    img = np.zeros((12, 20, 4), np.float32)
    want = mm.compile(src).render(img, t=0.3, interpret=True)
    got = mt.compile_source(src).render(img, t=0.3, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,msg", [("grayColor(noise([x, y]))", "length-3 tuple"),
                                     ("grayColor(noise(x, y))", "1 tuple or 3 scalar")])
def test_noise_argument_errors_match_the_reference(src, msg):
    img = np.zeros((4, 6, 4), np.float32)
    with pytest.raises(mm.MMTypeError, match=msg):
        mm.compile(src).render(img, interpret=True)
    with pytest.raises(mt.MMTypeError, match=msg):
        mt.compile_source(src).render(img, device="cpu")


NOISE_ENTRIES = ("camo", "caustics", "clouds", "hex_grid", "lava", "marble", "ridged_noise",
                 "rust", "turbulence", "voronoi", "warp_noise", "wood")


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
@pytest.mark.parametrize("name", NOISE_ENTRIES)
def test_noise_entries_match_the_oracle(name, case):
    got, want = render_against_oracle(name, *RENDER_CASES[case])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pallas_while", ["auto", "on"])
@pytest.mark.parametrize("name,params,route", [("ridged_noise", {}, "unroll"),
                                               ("ridged_noise", {"octaves": 5}, "masked"),
                                               ("voronoi", {}, "unroll")])
def test_loops_that_call_noise_stay_off_the_kernel(name, params, route, pallas_while):
    """ridged_noise's octave count folds at its default (a constant) and is
    a per-render value when passed: unrolled, else the masked loop;
    voronoi's 3x3 scan folds: unrolled, its inner loops too."""
    f = _library_filter(name)
    got = _routes(f, width=24, height=16, t=0.3, params=params,
                  options=mt.RenderOptions(pallas_while=pallas_while))
    assert got and set(got) == {route}
