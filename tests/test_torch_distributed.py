"""Multi-process renders of the port (mathmap_tpu_torch/parallel/
distributed.py) on the CPU, case for case with
tests/test_distributed_multiproc.py and the idempotency case of
tests/test_sharding.py.

Two OS processes form one fleet over gloo (`initialize`), each with four
CPU "devices": a sum over ranks and a ring send/recv (the reference's psum
and ppermute), then a row-sharded render over the global (1, 8, 1) mesh
whose rows split between the processes, evenly and 6 to 2 (`devices=` of
different lengths). Each rank writes its tiles (`local_slice_of`); the
parent holds them against the JAX package's NumPy oracle (rtol=1e-4,
atol=1e-5) and against the port's one-process render bit for bit. The
worker is this file's `__main__` block.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W = 16, 32
SRC = "in(xy * [0.8, 1.1]) + grayColor(x / W * 0.25)"
RTOL, ATOL = 1e-4, 1e-5


def _image():
    return (np.arange(H * W * 4, dtype=np.float32) % 97 / 97.0).reshape(H, W, 4)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: rows of the global (1, 8, 1) mesh each rank contributes, by split
SPLITS = {"even": None, "unequal": (6, 2)}


def _run_fleet(n: int, out_dir, timeout: float, split: str = "even"):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, MMTPU_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(i), str(n), coord, str(out_dir),
                               split],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def test_two_process_fleet_collectives_and_sharded_render(tmp_path):
    procs, outs = _run_fleet(2, tmp_path, timeout=220)
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        assert p.returncode == 0, f"worker {i} failed:\n{tail}"
        assert f"pid{i}: collectives OK" in out, tail
        assert f"pid{i}: sharded render OK (8 rows)" in out, tail
    _check_rows(tmp_path, (4, 4))


def test_two_process_fleet_with_an_unequal_split(tmp_path):
    """6 of the mesh's 8 rows on rank 0 and 2 on rank 1: each rank renders
    its own count of tiles, and neither hangs."""
    procs, outs = _run_fleet(2, tmp_path, timeout=220, split="unequal")
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        assert p.returncode == 0, f"worker {i} failed:\n{tail}"
        assert f"pid{i}: sharded render OK ({(12, 4)[i]} rows)" in out, tail
    _check_rows(tmp_path, SPLITS["unequal"])


def _check_rows(tmp_path, tiles_a_rank):
    """Each rank's 2-row tiles, in mesh order, against the oracle and the
    one-process render."""
    import mathmap_tpu as mm
    import mathmap_tpu_torch as mt

    img = _image()
    opts = mm.RenderOptions(interpolation="bilinear")
    oracle = np.asarray(mm.compile_source(SRC).render(img, width=W, height=H, t=0.37,
                                                      options=opts, interpret=True))
    whole = mt.compile_source(SRC).render(img, width=W, height=H, t=0.37, device="cpu",
                                          options=mt.RenderOptions(interpolation="bilinear"))
    rows = {}
    first = 0
    for i in range(2):
        with np.load(tmp_path / f"rank{i}.npz") as z:
            mine = sorted(int(key.split("_")[1]) for key in z.files)
            assert mine == list(range(first, first + tiles_a_rank[i]))
            first += tiles_a_rank[i]
            for key in z.files:
                rows[int(key.split("_")[1])] = z[key]
    assert sorted(rows) == list(range(8)) and len(rows) == 8  # 8 tiles of 2 rows
    for r0, tile in rows.items():
        r = r0 * 2
        np.testing.assert_allclose(tile, oracle[r:r + 2], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tile, whole[r:r + 2].numpy())


def test_distributed_single_process_smoke(tmp_path):
    """initialize twice (idempotent) in a one-process gloo group: not
    multihost, and a render over the global (1, 8, 1) mesh gives this
    process all 8 row tiles."""
    procs, outs = _run_fleet(1, tmp_path, timeout=220)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert "pid0: single OK" in outs[0]


def _worker(pid: int, n: int, coord: str, out_dir: str, split: str):
    import torch
    import torch.distributed as dist

    import mathmap_tpu_torch as mt
    from mathmap_tpu_torch.parallel import distributed

    distributed.initialize(coord, num_processes=n, process_id=pid)
    distributed.initialize(coord, num_processes=n, process_id=pid)  # idempotent
    assert dist.get_backend() == "gloo"
    assert distributed.is_multihost() == (n > 1)
    mine = 8 // n if SPLITS[split] is None else SPLITS[split][pid]
    mesh = distributed.global_mesh(rows=8, devices=["cpu"] * mine)
    assert mesh.devices.shape == (1, 8, 1)
    f = mt.compile_source(SRC)
    opts = mt.RenderOptions(interpolation="bilinear")
    frame = f.render_sharded(_image(), mesh=mesh, width=W, height=H, t=0.37, options=opts)
    tiles = distributed.local_slice_of(frame)
    assert len(tiles) == mine and all(tuple(t.shape) == (2, W, 4) for t in tiles)
    if n == 1:
        print("pid0: single OK", flush=True)
        dist.destroy_process_group()
        return
    if split == "unequal":
        _save_rows(out_dir, pid, frame)
        dist.barrier()
        print(f"pid{pid}: sharded render OK ({len(tiles) * 2} rows)", flush=True)
        dist.destroy_process_group()
        return
    # 1) a sum over ranks and a ring exchange: device i (4 a rank) holds
    # i + 1; every device gets the total and its ring neighbour's value
    vals = torch.arange(4, dtype=torch.float32) + 1 + 4 * pid
    total = vals.sum()
    dist.all_reduce(total)
    send, recv = vals[-1].clone(), torch.zeros(())
    ops = [dist.P2POp(dist.isend, send, (pid + 1) % n),
           dist.P2POp(dist.irecv, recv, (pid - 1) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    ring = torch.cat([recv.reshape(1), vals[:-1]])
    for i in range(4):
        g = 4 * pid + i
        got = float(total) * 0.001 + float(ring[i])
        want = 36.0 * 0.001 + ((g - 1) % 8 + 1)
        assert abs(got - want) < 1e-5, (pid, g, got, want)
    print(f"pid{pid}: collectives OK", flush=True)
    # 2) this rank's rows of the sharded render
    _save_rows(out_dir, pid, frame)
    print(f"pid{pid}: sharded render OK ({len(tiles) * 2} rows)", flush=True)
    dist.destroy_process_group()


def _save_rows(out_dir: str, pid: int, frame):
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"),
             **{f"tile_{r0 // 2}": t.numpy() for (r0, _c0), t in frame.tiles.items()})


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
