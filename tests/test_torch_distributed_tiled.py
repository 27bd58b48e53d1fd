"""The input-sharded render and the frame sweep over a mesh that spans
processes (mathmap_tpu_torch/parallel/halo.py, shard.py and
distributed.py) on the CPU.

One fleet of two OS processes over gloo, each with four CPU "devices"
(`global_mesh(..., devices=["cpu"] * 4)`), is started once for the module;
its worker is this file's `__main__` block. Every case runs on both ranks
in the same order, and each rank writes its tiles (or frame shards) to the
fleet's directory. Each case is then one test here: the ranks' tiles,
reassembled, against

- the JAX package's NumPy oracle (`render(..., interpret=True)`) at
  rtol=1e-4, atol=1e-5 (uint8 output within 1 LSB, the repo's rule for a
  packed render); with check=False and a halo too small the spec is the
  reference's own clamped `render_tiled` on its virtual devices;
- the port's one-process render over a CPU mesh of the same shape, bit for
  bit.

The cases: render_tiled of pond on (1,8,1) under edge wrap, color and
reflect (the ring crosses ranks both ways); bicubic on (1,2,4) (the row
phase across ranks, the column phase within one) and (1,4,2) (both partly
across); u8 in with uint8 out, f32 in, two inputs, an animated input at
frame 1; a LocalFrame from render_sharded fed to render_tiled; a region
that misses rank 0's tiles; halo 0; a halo too small whose violation lies
only in rank 1's tiles (both ranks raise the same error) and the same with
check=False. The staged blocks of every case are the tile plus its halos,
never the canvas. Then sweeps of 4 frames over (2,4,1) and (1,8,1) for
pond, default mandelbrot and static_tv (rand()), with their shard shapes.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W = 32, 32
T = 3
RTOL, ATOL = 1e-4, 1e-5
DEVICES_A_RANK = 4
POND = "filters/Distorts/pond.mm"
POND_PARAMS = {"amplitude": 1.5, "wavelength": 6.0, "phase": 0.4}
TWO = ("filter two (image p, image q) "
       "p(xy + xy:[0, 1.5 * sin(x / 5)]) * 0.6 + q(xy + xy:[1.5 * sin(y / 7), 0]) * 0.4 end")
#: a sample 3 rows up where y < 0 (rank 1's rows of (1,8,1)), none above
CHECK_SRC = "origVal(xy + xy:[0, 3 * clamp(-y, 0, 1)])"
POINTWISE = "filter f (image in) in(xy) * 0.5 + grayColor(x / W * 0.25) end"
EDGE_COLOR = (0.25, 0.5, 0.75, 1.0)
REGION = (3, 18, 20, 10)  # rows 18..27: rank 1's tiles of (1,8,1) only

#: name -> (mesh, source, params, halo, options, inputs, render kwargs, check)
TILED = {
    "rows_wrap": ((1, 8, 1), POND, POND_PARAMS, "auto",
                  dict(interpolation="bilinear", edge_x="wrap", edge_y="wrap"), "f32",
                  dict(t=0.3), True),
    "rows_color": ((1, 8, 1), POND, POND_PARAMS, "auto",
                   dict(interpolation="bilinear", edge_color=EDGE_COLOR), "f32", {}, True),
    "rows_reflect": ((1, 8, 1), POND, POND_PARAMS, "auto",
                     dict(interpolation="bilinear", edge_x="reflect", edge_y="reflect"),
                     "f32", {}, True),
    "mesh_1x2x4_bicubic": ((1, 2, 4), POND, POND_PARAMS, "auto",
                           dict(interpolation="bicubic", edge_x="wrap", edge_y="wrap"),
                           "f32", {}, True),
    "mesh_1x4x2_bicubic": ((1, 4, 2), POND, POND_PARAMS, "auto",
                           dict(interpolation="bicubic", edge_x="reflect",
                                edge_y="color", edge_color=EDGE_COLOR), "f32", {}, True),
    "u8_in_u8_out": ((1, 8, 1), POND, POND_PARAMS, "auto",
                     dict(interpolation="bilinear", output_dtype="uint8"), "u8", {}, True),
    "f32_in": ((1, 2, 4), POND, POND_PARAMS, "auto", dict(interpolation="bilinear"), "f32",
               dict(t=0.7), True),
    "two_inputs": ((1, 4, 2), TWO, {}, "auto", dict(interpolation="bilinear"), "two", {},
                   True),
    "animated_frame1": ((1, 8, 1), POND, POND_PARAMS, "auto",
                        dict(interpolation="bilinear"), "stack", dict(frame=1.0), True),
    "region_misses_rank0": ((1, 8, 1), POND, POND_PARAMS, "auto",
                            dict(interpolation="bilinear", region=REGION), "f32", {}, True),
    "halo_zero": ((1, 8, 1), POINTWISE, {}, 0, dict(interpolation="nearest"), "f32", {},
                  True),
    "unchecked_small_halo": ((1, 8, 1), CHECK_SRC, {}, 1, dict(interpolation="bilinear"),
                             "f32", {}, False),
}
CHECK_CASE = ((1, 8, 1), CHECK_SRC, {}, 1, dict(interpolation="bilinear"), "f32", {}, True)
#: render_sharded over (1,4,2), then render_tiled of its LocalFrame
CHAIN_MESH = (1, 4, 2)
TWIRL = "filters/Distorts/twirl.mm"
#: name -> (source, params, number of image inputs)
SWEEP_SOURCES = {
    "pond": (POND, POND_PARAMS, 1),
    "mandelbrot": ("filters/Render/mandelbrot.mm", {}, 0),
    "static_tv": ("filters/Noise/static_tv.mm", {}, 1),
}
SWEEP_MESHES = ((2, 4, 1), (1, 8, 1))
SWEEPS = {f"{name}_{'x'.join(map(str, m))}": (name, m)
          for name in SWEEP_SOURCES for m in SWEEP_MESHES}
FRAMES = 4


def _image(seed, h=H, w=W):
    img = np.random.RandomState(seed).rand(h, w, 4).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _inputs(kind):
    if kind == "u8":
        return [(np.random.RandomState(44).rand(H, W, 4) * 255).astype(np.uint8)]
    if kind == "two":
        return [_image(70), _image(71)]
    if kind == "stack":
        return [np.stack([_image(80 + k) for k in range(T)])]
    return [_image(9)]


def _compile(pkg, src):
    if src.endswith(".mm"):
        return pkg.compile_file(str(ROOT / src))
    return pkg.compile_source(src)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the parent: one fleet for the module ------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("fleet")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, MMTPU_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(i), "2", coord, str(out_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"fleet rank {i} failed:\n{tail}"
        assert f"rank{i}: all cases done" in out, tail
    return out_dir


def _tiles(out_dir, case):
    """{origin: tile} of both ranks, with the rank that wrote each."""
    tiles = {}
    for rank in range(2):
        with np.load(out_dir / f"{case}_rank{rank}.npz") as z:
            for key in z.files:
                tiles[tuple(int(v) for v in key.split("_"))] = (rank, z[key])
    return tiles


def _assemble(tiles, shape, dtype):
    whole = np.zeros(shape, dtype)
    for origin, (_rank, tile) in tiles.items():
        index = tuple(slice(o, o + n) for o, n in zip(origin, tile.shape))
        whole[index] = tile
    return whole


def _port_mesh(mt, shape):
    return mt.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _owner(mesh_shape, index):
    """The rank that owns a mesh entry: global_mesh puts each rank's
    DEVICES_A_RANK entries in rank order."""
    return int(np.ravel_multi_index(index, mesh_shape)) // DEVICES_A_RANK


def _check_origins(tiles, mesh_shape, tile_shape, lead=0):
    """Every tile once, at its entry's origin, written by the entry's owner."""
    nf, ny, nx = mesh_shape
    want = {}
    for f, r, c in np.ndindex(*mesh_shape):
        origin = (r * tile_shape[-3], c * tile_shape[-2])
        if lead:
            origin = (f * lead,) + origin
        elif f:
            continue
        want[origin] = _owner(mesh_shape, (f, r, c))
    assert {o: rank for o, (rank, _t) in tiles.items()} == want
    assert all(t.shape == tile_shape for _r, t in tiles.values())


def _oracle_tiled(mm, src, params, opts, inputs, kw):
    ro = mm.RenderOptions(**{k: v for k, v in opts.items() if k != "region"})
    want = np.asarray(_compile(mm, src).render(*inputs, width=W, height=H, options=ro,
                                               params=params, interpret=True, **kw))
    if "region" in opts:
        x, y, w, h = opts["region"]
        canvas = inputs[0].copy()
        canvas[y:y + h, x:x + w] = want[y:y + h, x:x + w]
        want = canvas
    return want


def _hold(got, want):
    if want.dtype == np.uint8:
        assert got.dtype == np.uint8
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(TILED))
def test_render_tiled_across_ranks(fleet, case):
    import jax

    import mathmap_tpu as mm
    import mathmap_tpu_torch as mt
    from mathmap_tpu.parallel.mesh import make_mesh as ref_make_mesh

    mesh_shape, src, params, halo, opts, kind, kw, check = TILED[case]
    inputs = _inputs(kind)
    tiles = _tiles(fleet, case)
    ny, nx = mesh_shape[1:]
    u8_out = opts.get("output_dtype") == "uint8"
    _check_origins(tiles, mesh_shape, (H // ny, W // nx, 4))
    got = _assemble(tiles, (H, W, 4), np.uint8 if u8_out else np.float32)
    one = _compile(mt, src).render_tiled(*inputs, mesh=_port_mesh(mt, mesh_shape), halo=halo,
                                         options=mt.RenderOptions(**opts), params=params,
                                         check=check, **kw)
    np.testing.assert_array_equal(got, one.numpy())
    if check:
        want = _oracle_tiled(mm, src, params, opts, inputs, kw)
    else:
        want = np.asarray(_compile(mm, src).render_tiled(
            *inputs, halo=halo, check=False, options=mm.RenderOptions(**opts),
            mesh=ref_make_mesh(*mesh_shape, devices=jax.devices()[:int(np.prod(mesh_shape))])))
    _hold(got, want)


def test_a_region_off_rank_0_passes_its_tiles_through(fleet):
    """Rank 0's tiles miss the selection: they are input 0 bit for bit,
    and the rank still sent its halo rows and joined the check."""
    tiles = _tiles(fleet, "region_misses_rank0")
    img = _inputs("f32")[0]
    for (r0, c0), (rank, tile) in tiles.items():
        if rank == 0:
            np.testing.assert_array_equal(tile, img[r0:r0 + tile.shape[0], c0:c0 + W])


def test_the_staged_blocks_are_each_tile_and_its_halos(fleet):
    """No rank stages the canvas: every block a tile samples is its own
    rows (and columns) plus the halos, one a tile and input."""
    for rank in range(2):
        staged = json.loads((fleet / f"staged_rank{rank}.json").read_text())
        for case, (mesh_shape, *_rest, kind, _kw, _check) in TILED.items():
            ny, nx = mesh_shape[1:]
            blocks = staged[case]
            n_inputs = len(_inputs(kind))
            evaluated = 4 if case != "region_misses_rank0" else (0 if rank == 0 else 3)
            assert len(blocks) == evaluated * n_inputs, (case, rank, blocks)
            for shape, hy, hx in blocks:
                assert shape[-3:] == [H // ny + 2 * hy, W // nx + 2 * hx, 4], (case, shape)
                assert shape[-3] < H, (case, shape)
                assert len(shape) == (4 if kind == "stack" else 3)


def test_a_halo_violation_on_rank_1_raises_the_same_error_on_both_ranks(fleet):
    import mathmap_tpu_torch as mt

    texts = [(fleet / f"check_rank{rank}.txt").read_text() for rank in range(2)]
    assert texts[0] == texts[1]
    assert texts[0].startswith("MMRuntimeError") and "bounded-displacement" in texts[0]
    mesh_shape, src, params, halo, opts, _kind, _kw, _check = CHECK_CASE
    f = mt.compile_source(src)
    img = _inputs("f32")[0]
    mesh = _port_mesh(mt, mesh_shape)
    with pytest.raises(mt.MMRuntimeError) as err:
        f.render_tiled(img, mesh=mesh, halo=halo, options=mt.RenderOptions(**opts))
    assert texts[0] == f"MMRuntimeError: {err.value}"
    # the violation lies in rank 1's rows only: rank 0's rows alone pass
    f.render_tiled(img, mesh=mesh, halo=halo,
                   options=mt.RenderOptions(region=(0, 0, W, H // 2), **opts))
    with pytest.raises(mt.MMRuntimeError):
        f.render_tiled(img, mesh=mesh, halo=halo,
                       options=mt.RenderOptions(region=(0, H // 2, W, H // 2), **opts))


def test_a_local_frame_chains_into_render_tiled(fleet):
    """render_sharded's LocalFrame over the global mesh feeds render_tiled
    over the same mesh: no rank holds the canvas between the filters."""
    import mathmap_tpu as mm
    import mathmap_tpu_torch as mt

    img = _inputs("f32")[0]
    ny, nx = CHAIN_MESH[1:]
    tiles = _tiles(fleet, "chain")
    _check_origins(tiles, CHAIN_MESH, (H // ny, W // nx, 4))
    got = _assemble(tiles, (H, W, 4), np.float32)
    mesh = _port_mesh(mt, CHAIN_MESH)
    mid = mt.compile_file(str(ROOT / TWIRL)).render_sharded(img, mesh=mesh)
    one = mt.compile_file(str(ROOT / POND)).render_tiled(mid, mesh=mesh, params=POND_PARAMS)
    np.testing.assert_array_equal(got, one.numpy())
    mid = np.asarray(mm.compile_file(str(ROOT / TWIRL)).render(img, interpret=True))
    want = np.asarray(mm.compile_file(str(ROOT / POND)).render(mid, params=POND_PARAMS,
                                                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_a_sweep_across_ranks(fleet, case):
    import mathmap_tpu as mm
    import mathmap_tpu_torch as mt

    name, mesh_shape = SWEEPS[case]
    src, params, n_inputs = SWEEP_SOURCES[name]
    inputs = [_image(9)] * n_inputs
    nf, ny, nx = mesh_shape
    tiles = _tiles(fleet, case)
    _check_origins(tiles, mesh_shape, (FRAMES // nf, H // ny, W // nx, 4), lead=FRAMES // nf)
    got = _assemble(tiles, (FRAMES, H, W, 4), np.float32)
    one = _compile(mt, src).render_sharded(*inputs, mesh=_port_mesh(mt, mesh_shape),
                                           num_frames=FRAMES, width=W, height=H, params=params)
    np.testing.assert_array_equal(got, one.numpy())
    f = _compile(mm, src)
    for i in range(FRAMES):
        t = float(np.float32(i) / np.float32(FRAMES - 1))
        want = np.asarray(f.render(*inputs, width=W, height=H, t=t, frame=float(i),
                                   params=params, interpret=True))
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL)


def test_local_slice_of_gives_a_sweeps_shards_in_mesh_order(fleet):
    for case, (_name, mesh_shape) in SWEEPS.items():
        nf, ny, nx = mesh_shape
        per = FRAMES // nf
        for rank in range(2):
            rec = json.loads((fleet / f"{case}_rank{rank}.json").read_text())
            local = [idx for idx in np.ndindex(*mesh_shape) if _owner(mesh_shape, idx) == rank]
            assert rec["origins"] == [[f * per, r * H // ny, c * W // nx] for f, r, c in local]
            assert rec["shapes"] == [[per, H // ny, W // nx, 4]] * len(local)
            assert rec["shape"] == [FRAMES, H, W, 4]


def test_a_local_frame_needs_the_mesh_that_spans_processes():
    import torch

    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.parallel.shard import LocalFrame

    frame = LocalFrame({(0, 0): torch.zeros(H // 2, W, 4)}, (H, W, 4))
    with pytest.raises(ValueError, match="LocalFrame"):
        mt.compile_source("origVal(xy)").render_tiled(frame, mesh=_port_mesh(mt, (1, 2, 1)))


# -- the worker: one rank of the fleet ----------------------------------------

def _worker(rank: int, n: int, coord: str, out_dir: str):
    import torch.distributed as dist

    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.parallel import distributed, halo

    out = pathlib.Path(out_dir)
    distributed.initialize(coord, num_processes=n, process_id=rank)
    staged: dict = {}
    current: list = []

    tiled_input = halo.TiledInput

    def recording_input(**fields):
        block = tiled_input(**fields)
        current.append([list(block.pixels.shape), block.halo_y, block.halo_x])
        return block

    halo.TiledInput = recording_input

    def save(case, frame):
        np.savez(out / f"{case}_rank{rank}.npz",
                 **{"_".join(map(str, o)): t.numpy() for o, t in frame.tiles.items()})

    def mesh_of(shape):
        mesh = distributed.global_mesh(*shape, devices=["cpu"] * DEVICES_A_RANK)
        assert mesh.devices.shape == shape
        return mesh

    def tiled(spec):
        mesh_shape, src, params, halo_, opts, kind, kw, check = spec
        return _compile(mt, src).render_tiled(
            *_inputs(kind), mesh=mesh_of(mesh_shape), halo=halo_,
            options=mt.RenderOptions(**opts), params=params, check=check, **kw)

    for case, spec in TILED.items():
        current.clear()
        frame = tiled(spec)
        staged[case] = list(current)
        save(case, frame)
        print(f"rank{rank}: {case} OK", flush=True)
    (out / f"staged_rank{rank}.json").write_text(json.dumps(staged))
    try:
        tiled(CHECK_CASE)
        raise AssertionError("a halo too small did not raise")
    except mt.MMRuntimeError as e:
        (out / f"check_rank{rank}.txt").write_text(f"MMRuntimeError: {e}")
    mesh = mesh_of(CHAIN_MESH)
    mid = mt.compile_file(str(ROOT / TWIRL)).render_sharded(_inputs("f32")[0], mesh=mesh)
    save("chain", mt.compile_file(str(ROOT / POND)).render_tiled(mid, mesh=mesh,
                                                                 params=POND_PARAMS))
    for case, (name, mesh_shape) in SWEEPS.items():
        src, params, n_inputs = SWEEP_SOURCES[name]
        frame = _compile(mt, src).render_sharded(
            *[_image(9)] * n_inputs, mesh=mesh_of(mesh_shape), num_frames=FRAMES,
            width=W, height=H, params=params)
        save(case, frame)
        (out / f"{case}_rank{rank}.json").write_text(json.dumps({
            "origins": [list(o) for o in frame.tiles],
            "shapes": [list(s.shape) for s in distributed.local_slice_of(frame)],
            "shape": list(frame.shape)}))
    print(f"rank{rank}: all cases done", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
