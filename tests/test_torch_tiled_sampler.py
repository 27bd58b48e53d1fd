"""Kernel B4's plain version against the reference's tiled gather, and the
wrapper's contract.

`sample_tiled_reference` (the CPU route of the port's tiled sampler) is held
against the reference's `runtime/sampling._sample_xla` on a
`value.TiledInput` with the NumPy backend (the exact gather route the
reference's Pallas tiled route is tested against) for every interpolation x
edge pair, on the blocks of a top, an interior and a bottom row tile, of
column-split tiles, of 1-device axes, with coordinates in and far out of
the halo contract, at rtol=1e-4, atol=1e-5; the excess must equal the
reference's violation hook's value. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from mathmap_tpu.runtime import sampling as ref_sampling
from mathmap_tpu.runtime.options import RenderOptions as RefOptions
from mathmap_tpu.runtime.tracer import Evaluator as RefEvaluator
from mathmap_tpu.runtime.tracer import RenderContext as RefContext
from mathmap_tpu.runtime.value import TiledInput as RefTiledInput
from mathmap_tpu.runtime.value import localize_period as ref_localize
from mathmap_tpu_torch.kernels import sample_tiled as B4
from mathmap_tpu_torch.runtime.value import localize_period

RTOL, ATOL = 1e-4, 1e-5
INTERPOLATIONS = ("nearest", "bilinear", "bicubic")
EDGE_PAIRS = (("color", "color"), ("wrap", "wrap"), ("reflect", "reflect"),
              ("wrap", "reflect"), ("color", "wrap"))
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)
GH, GW = 24, 20  # the global frame

#: name -> (tile rows, tile cols, halo_y, halo_x, mesh rows, mesh cols,
#: tile's row index, tile's col index): the block a tile of that mesh holds
TILES = {
    "top": (6, GW, 5, 0, 4, 1, 0, 0),
    "interior": (6, GW, 5, 0, 4, 1, 2, 0),
    "bottom": (6, GW, 5, 0, 4, 1, 3, 0),
    "cols_corner": (12, 5, 4, 4, 2, 4, 0, 3),
    "cols_interior": (12, 5, 4, 4, 2, 4, 1, 1),
    "one_device_axis": (GH, GW, 4, 0, 1, 1, 0, 0),
    "thin_halo": (6, GW, 1, 0, 4, 1, 1, 0),
}


def _block(name, seed):
    th, tw, hy, hx, ny, nx, r, c = TILES[name]
    ext = np.random.RandomState(seed).rand(th + 2 * hy, tw + 2 * hx if nx > 1 else GW,
                                           4).astype(np.float32)
    geom = dict(gh=GH, gw=GW, row_base=r * th - hy,
                col_base=c * tw - hx if nx > 1 else 0, col_sharded=nx > 1)
    return ext, geom, (th, tw, r, c, hy, hx if nx > 1 else None)


def _coords(name, seed, contract):
    """World coordinates of the tile's pixels displaced by up to its halo
    less the bicubic margin (contract=True), or far beyond it and outside
    the frame (False)."""
    th, tw, r, c, hy, hx = _block(name, 0)[2]
    rs = np.random.RandomState(seed)
    rows = np.arange(r * th, (r + 1) * th)[:, None] + np.zeros((1, tw))
    cols = np.arange(c * tw, (c + 1) * tw)[None, :] + np.zeros((th, 1))
    x = cols + 0.5 - GW / 2
    y = GH / 2 - 0.5 - rows
    if contract:
        dx = 3.0 if hx is None else max(hx - 3.0, 0.0)
        dy = max(hy - 3.0, 0.0)
        x = x + rs.uniform(-dx, dx, x.shape)
        y = y + rs.uniform(-dy, dy, y.shape)
    else:
        x = x + rs.uniform(-3 * GW, 3 * GW, x.shape)
        y = y + rs.uniform(-3 * GH, 3 * GH, y.shape)
    return x.astype(np.float32), y.astype(np.float32)


def _reference(ext, geom, x, y, interp, ex, ey):
    opts = RefOptions(interpolation=interp, edge_x=ex, edge_y=ey, edge_color=EDGE_COLOR)
    ctx = RefContext(be=np, width=GW, height=GH, opts=opts, is_jax=False,
                     dtype=np.float32, grid_shape=x.shape)
    seen = []
    img = RefTiledInput(pixels=ext, global_height=geom["gh"],
                        global_width=geom["gw"] if geom["col_sharded"] else 0,
                        row_base=geom["row_base"], col_base=geom["col_base"],
                        violation_hook=lambda e: seen.append(int(e)))
    ev = RefEvaluator(ctx, x, y, {})
    out = ref_sampling._sample_xla(ev, img, x, y)
    return np.stack([np.broadcast_to(c, x.shape) for c in out]), max(seen)


@pytest.mark.parametrize("contract", [True, False], ids=["in_contract", "out_of_contract"])
@pytest.mark.parametrize("ex,ey", EDGE_PAIRS)
@pytest.mark.parametrize("interp", INTERPOLATIONS)
@pytest.mark.parametrize("tile", sorted(TILES))
def test_plain_tiled_sampler_matches_reference(tile, interp, ex, ey, contract):
    ext, geom, _ = _block(tile, seed=3)
    x, y = _coords(tile, seed=4, contract=contract)
    before = B4.sample_tiled.launches
    got, excess = B4.sample_tiled(torch.from_numpy(ext), torch.from_numpy(x),
                                  torch.from_numpy(y), interpolation=interp,
                                  edge_x=ex, edge_y=ey, edge_color=EDGE_COLOR, **geom)
    assert B4.sample_tiled.launches == before  # CPU tensors never launch
    assert got.shape == (4, *x.shape) and got.dtype == torch.float32
    assert excess.dtype == torch.int32 and excess.dim() == 0
    want, want_excess = _reference(ext, geom, x, y, interp, ex, ey)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert int(excess) == want_excess
    if contract and tile != "thin_halo":
        assert int(excess) <= 0


def test_check_false_gives_no_excess_and_the_same_samples():
    ext, geom, _ = _block("interior", seed=5)
    x, y = (torch.from_numpy(a) for a in _coords("interior", seed=6, contract=False))
    a, e = B4.sample_tiled(torch.from_numpy(ext), x, y, interpolation="bicubic",
                           edge_x="wrap", edge_y="reflect", edge_color=EDGE_COLOR,
                           check=False, **geom)
    b, _ = B4.sample_tiled_reference(torch.from_numpy(ext), x, y, interpolation="bicubic",
                                     edge_x="wrap", edge_y="reflect",
                                     edge_color=EDGE_COLOR, **geom)
    assert e is None and torch.equal(a, b)


def test_an_empty_grid_samples_nothing():
    ext, geom, _ = _block("top", seed=5)
    x = torch.zeros(0, 7)
    out, excess = B4.sample_tiled(torch.from_numpy(ext), x, x, interpolation="bilinear",
                                  edge_x="color", edge_y="color", edge_color=EDGE_COLOR,
                                  **geom)
    assert out.shape == (4, 0, 7) and int(excess) == B4.NO_EXCESS


@pytest.mark.parametrize("n,ext_n,base", [(24, 12, -3), (24, 12, 9), (24, 12, 21),
                                          (24, 32, -4), (7, 5, -2), (7, 13, -3),
                                          (100, 30, 50), (100, 30, 80)])
def test_localize_period_matches_reference(n, ext_n, base):
    g = np.random.RandomState(n + ext_n).randint(-2 * n, 3 * n, (9, 11)).astype(np.int32)
    got = localize_period(torch.from_numpy(g), base, n, ext_n)
    want = ref_localize(np, g, base, n, ext_n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "u8", "shape", "contiguous", "coords", "interp",
                                 "edge", "edge_color", "width", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ext = torch.zeros(12, GW, 4)
    x = torch.zeros(6, GW)
    y = torch.zeros(6, GW)
    args = dict(ext=ext, x=x, y=y, gh=GH, gw=GW, row_base=3, col_base=0,
                col_sharded=False, interpolation="bilinear", edge_x="color",
                edge_y="color", edge_color=EDGE_COLOR)
    if bad == "dtype":
        args["ext"] = ext.double()
    elif bad == "u8":
        args["ext"] = ext.to(torch.uint8)
    elif bad == "shape":
        args["ext"] = torch.zeros(12, GW, 3)
    elif bad == "contiguous":
        args["x"] = torch.zeros(GW, 6).t()
    elif bad == "coords":
        args["y"] = torch.zeros(6, GW + 1)
    elif bad == "interp":
        args["interpolation"] = "lanczos"
    elif bad == "edge":
        args["edge_y"] = "clamp"
    elif bad == "edge_color":
        args["edge_color"] = (0.0, 0.0)
    elif bad == "width":
        args["gw"] = GW + 1
    elif bad == "device":
        args["ext"] = torch.zeros(12, GW, 4, device="meta")
    with pytest.raises((ValueError, TypeError)):
        B4.sample_tiled(**args)
