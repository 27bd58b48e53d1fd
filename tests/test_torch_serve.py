"""The port's render service (mathmap_tpu_torch/serve.py) on the CPU: the
coalescing dispatcher and the HTTP endpoints.

The cases mirror tests/test_serve.py, its artifact cases included (the
artifacts exported on the CPU), except the bucket-padding half of its
dispatch test (the port dispatches the true group size). Every job must equal its lone render
BIT FOR BIT (a batch job is its lone render, runtime/render.iter_jobs), the
concurrent requests must show a batch_hist size above 1, and one /render
must be within 1 u8 level of the JAX package's service for the same
request.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mathmap_tpu_torch as mt
from mathmap_tpu_torch.imgio.png import decode_png, encode_png
from mathmap_tpu_torch.serve import RenderService, _Job, make_handler

H, W = 24, 32


@pytest.fixture(scope="module")
def service():
    svc = RenderService(max_batch=8, window_ms=30.0, device="cpu")
    yield svc
    svc.shutdown()


def _img(seed=0):
    return np.random.RandomState(seed).rand(H, W, 4).astype(np.float32)


def _lone(filt, img, u8=True, **kw):
    """The lone CPU render a service job must equal, bit for bit."""
    opts = kw.pop("options", mt.RenderOptions())
    if u8:
        from dataclasses import replace

        opts = replace(opts, output_dtype="uint8")
    args = [img] if img is not None else []
    return filt.render(*args, width=W, height=H, options=opts, device="cpu", **kw).numpy()


def test_render_sync_matches_direct(service):
    img = _img()
    out = service.render_sync("twirl", [img], W, H, t=0.3, params={"angle": 2.0})
    assert out.dtype == np.uint8
    filt = mt.default_db().compile("twirl")
    np.testing.assert_array_equal(out, _lone(filt, img, t=0.3, params={"angle": 2.0}))


def _concurrently(n, fn):
    results = [None] * n
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, fn(i)))
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    return results


def test_concurrent_jobs_microbatch_and_match(service):
    imgs = [_img(s) for s in range(6)]
    ts = [0.1 * (i + 1) for i in range(6)]
    before = service.snapshot()["dispatches"]
    results = _concurrently(6, lambda i: service.render_sync("pond", [imgs[i]], W, H, t=ts[i]))
    after = service.snapshot()
    assert any(int(k) > 1 for k in after["batch_hist"]), after["batch_hist"]
    assert after["dispatches"] - before < 6, "no batching happened"
    filt = mt.default_db().compile("pond")
    for i in range(6):
        np.testing.assert_array_equal(results[i], _lone(filt, imgs[i], t=ts[i]))


def test_per_job_param_values_batch_and_match(service):
    img = _img(9)
    angles = [1.0, 2.5, 4.0, 5.5]
    before = service.snapshot()["dispatches"]
    results = _concurrently(4, lambda i: service.render_sync(
        "twirl", [img], W, H, params={"angle": angles[i]}))
    assert service.snapshot()["dispatches"] - before < 4, "no batching across values"
    filt = mt.default_db().compile("twirl")
    for i, a in enumerate(angles):
        np.testing.assert_array_equal(results[i], _lone(filt, img, params={"angle": a}))
    assert np.abs(results[0].astype(np.int16) - results[2].astype(np.int16)).max() > 1


def test_render_batch_params_list_api():
    filt = mt.default_db().compile("twirl")
    imgs = np.stack([_img(s) for s in range(3)])
    outs = filt.render_batch(imgs, ts=[0.1, 0.2, 0.3], frames=[0, 0, 0], width=W, height=H,
                             params=[{"angle": a} for a in (1.0, 3.0, 5.0)], device="cpu")
    for i, a in enumerate((1.0, 3.0, 5.0)):
        direct = filt.render(imgs[i], width=W, height=H, t=0.1 * (i + 1),
                             params={"angle": a}, device="cpu")
        assert torch.equal(outs[i], direct)
    with pytest.raises(ValueError, match="param dicts"):
        filt.render_batch(imgs, ts=[0.1, 0.2, 0.3], width=W, height=H,
                          params=[{"angle": 1.0}], device="cpu")
    with pytest.raises(ValueError, match="same"):
        filt.render_batch(imgs, ts=[0.1, 0.2, 0.3], width=W, height=H,
                          params=[{"angle": 1.0}, {}, {"angle": 2.0}], device="cpu")


def test_error_propagates(service):
    with pytest.raises(Exception):
        service.render_sync("no_such_filter_xyz", [], W, H)


def test_source_spec_compiles(service):
    out = service.render_sync({"source": "filter f () grayColor(0.25) end"}, [], W, H)
    assert out.dtype == np.uint8
    assert (out[..., 0] == 64).all()


# -- HTTP front end ----------------------------------------------------

def _start(handler):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def http_server(service):
    httpd, base = _start(make_handler(service))
    yield base
    httpd.shutdown()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_bytes(base, path, obj):
    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return r.status, r.read(), dict(r.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_b64(arr):
    """A request image as the reference's tests send it: RGB PNG bytes."""
    u8 = (np.clip(arr[..., :3], 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(u8)).decode()


def _request_u8(arr):
    """The decoded request image (RGB -> RGBA, opaque)."""
    return decode_png(base64.b64decode(_png_b64(arr)))


def test_http_healthz_stats(http_server):
    code, body = _get(http_server, "/healthz")
    assert code == 200 and body["ok"] is True and body["platform"] == "cpu"
    code, body = _get(http_server, "/stats")
    assert code == 200 and "dispatches" in body


def test_http_render_roundtrip(http_server):
    img = _img(3)
    code, body = _post(http_server, "/render", {
        "filter": "twirl", "width": W, "height": H, "t": 0.2,
        "params": {"angle": 3.0}, "inputs": [_png_b64(img)]})
    assert code == 200, body
    arr = decode_png(base64.b64decode(body["image"]))
    assert arr.shape == (H, W, 4)
    filt = mt.default_db().compile("twirl")
    np.testing.assert_array_equal(arr, _lone(filt, _request_u8(img), t=0.2,
                                             params={"angle": 3.0}))


def test_http_render_png_level(http_server):
    src = {"source": "filter f () grayColor(x / W + 0.5) end"}
    outs = {}
    for level in (0, 1):
        code, body = _post(http_server, "/render", {
            "filter": src, "width": W, "height": H, "png_level": level})
        assert code == 200, body
        outs[level] = base64.b64decode(body["image"])
    assert len(outs[0]) > len(outs[1])
    np.testing.assert_array_equal(decode_png(outs[0]), decode_png(outs[1]))


def test_http_render_raw_format(http_server):
    code, body = _post(http_server, "/render", {
        "filter": {"source": "filter f () grayColor(x / W + 0.5) end"},
        "width": W, "height": H, "format": "raw"})
    assert code == 200, body
    assert body["dtype"] == "uint8"
    arr = np.frombuffer(base64.b64decode(body["data"]),
                        np.dtype(body["dtype"])).reshape(body["shape"])
    assert arr.shape == (H, W, 4)
    assert arr[0, -1, 0] > arr[0, 0, 0]


def test_http_bad_requests(http_server):
    code, body = _post(http_server, "/render", {"width": W})  # no filter
    assert code == 400 and "error" in body
    code, body = _post(http_server, "/render", {
        "filter": "twirl (", "width": W, "height": H})
    assert code == 400
    code, body = _post(http_server, "/nope", {})
    assert code == 404


def test_http_warmup(http_server, service):
    code, body = _post(http_server, "/warmup", {
        "filter": "pond", "width": W, "height": H, "batch_sizes": [1, 3]})
    assert code == 200 and body["ok"] is True


def test_animate_sync_matches_render_animation(service):
    img = _img(7)
    frames = service.animate_sync("ripple", [img], W, H, num_frames=3)
    filt = mt.default_db().compile("ripple")
    direct = filt.render_animation(img, num_frames=3, width=W, height=H, device="cpu",
                                   options=mt.RenderOptions(output_dtype="uint8"))
    np.testing.assert_array_equal(frames, direct.numpy())


def test_http_animate_gif(http_server):
    pytest.importorskip("PIL")
    from mathmap_tpu_torch.imgio.images import read_animation

    code, body = _post(http_server, "/animate", {
        "filter": "ripple", "width": W, "height": H, "num_frames": 3,
        "inputs": [_png_b64(_img(2))]})
    assert code == 200, body
    gif = read_animation(io.BytesIO(base64.b64decode(body["gif"])), as_uint8=True)
    assert gif.shape[0] == 3


def test_http_animate_raw(http_server, service):
    code, body = _post(http_server, "/animate", {
        "filter": {"source": "filter f () grayColor(t) end"}, "width": W, "height": H,
        "num_frames": 4, "format": "raw"})
    assert code == 200, body
    arr = np.frombuffer(base64.b64decode(body["data"]), np.uint8).reshape(body["shape"])
    assert arr.shape == (4, H, W, 4)
    np.testing.assert_array_equal(arr[:, 0, 0, 0], [0, 64, 128, 191])


def test_dispatch_records_the_group_size_and_frame_zero(service):
    """A group of 3 dispatches as 3 jobs (no padding) at frame 0, each
    equal to its lone twin, even for a filter that READS the frame."""
    src = ("filter fr (image in) "
           "in(xy) * 0.5 + grayColor(frame * 0.1) * 0.5 end")
    filt = service.get_filter({"source": src})
    imgs = [_img(s) for s in (11, 12, 13)]
    calls = []
    orig = filt.render_batch

    def spy(*a, **kw):
        calls.append(len(kw["ts"]))
        return orig(*a, **kw)

    filt.render_batch = spy
    try:
        jobs = [_Job(sig="s", filt=filt, inputs=[imgs[i]], t=0.2 * i, params={},
                     width=W, height=H, options=mt.RenderOptions()) for i in range(3)]
        before = service.snapshot()["batch_hist"].get("3", 0)
        service._dispatch(jobs)
    finally:
        del filt.render_batch
    assert calls == [3]
    assert service.snapshot()["batch_hist"]["3"] == before + 1
    for i, j in enumerate(jobs):
        assert j.error is None, j.error
        assert j.result.dtype == np.float32  # explicit options
        np.testing.assert_array_equal(j.result, _lone(filt, imgs[i], u8=False, t=0.2 * i))


def test_warmup_batch_sizes(service):
    filt = service.warmup("pond", W, H, batch_sizes=(1, 2))
    imgs = np.stack([_img(20), _img(21)])
    outs = filt.render_batch(imgs, ts=[0.3, 0.4], frames=np.zeros(2, np.float32),
                             width=W, height=H, params=[{}, {}], device="cpu")
    direct = filt.render(imgs[1], width=W, height=H, t=0.4, device="cpu")
    assert torch.equal(outs[1], direct)


@pytest.mark.parametrize("seed", [0, 1])
def test_concurrent_mixed_programs_no_crosstalk(service, seed):
    from tests.test_fuzz import ExprGen

    rng = np.random.RandomState(40 + seed)
    sources = []
    for k in range(4):
        body = ExprGen(100 * seed + k).scalar()
        sources.append(
            f"filter f{k} (image in, float p: 0-2 (1)) "
            f"grayColor(clamp(({body}) * 0.3 + p * 0.2, 0, 1)) end")
    jobs = [(sources[rng.randint(4)], _img(int(rng.randint(50))),
             float(rng.rand()), {"p": float(rng.uniform(0, 2))})
            for _ in range(12)]
    results = _concurrently(len(jobs), lambda i: service.render_sync(
        {"source": jobs[i][0]}, [jobs[i][1]], W, H, t=jobs[i][2], params=jobs[i][3]))
    for i, (src, img, t, ps) in enumerate(jobs):
        np.testing.assert_array_equal(results[i], _lone(mt.compile(src), img, t=t, params=ps))


def test_mixed_dtype_jobs_never_group(service):
    f32 = _img(11)
    u8 = (np.clip(f32, 0, 1) * 255 + 0.5).astype(np.uint8)
    src = {"source": "filter f (image in) in(xy) end"}
    jobs = [service.submit(src, [u8], W, H), service.submit(src, [f32], W, H)]
    assert jobs[0].sig != jobs[1].sig
    for j in jobs:
        assert j.done.wait(120)
        assert j.error is None, j.error
    a, b = (np.asarray(j.result) for j in jobs)
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_http_supersample_scheme_honored(http_server):
    src = {"source": "filter f () grayColor(x * x / (W * W) * 4) end"}
    outs = {}
    for scheme in ("grid", "corners"):
        code, body = _post(http_server, "/render", {
            "filter": src, "width": W, "height": H, "format": "raw",
            "supersample": 2, "supersample_scheme": scheme})
        assert code == 200, body
        outs[scheme] = np.frombuffer(base64.b64decode(body["data"]), np.uint8)
    assert not np.array_equal(outs["grid"], outs["corners"])
    lone = _lone(mt.compile_source(src["source"]), None, options=mt.RenderOptions(
        supersample=2, supersample_scheme="corners"))
    np.testing.assert_array_equal(outs["corners"], lone.ravel())


def test_http_edge_color_option_forwarded(http_server):
    src = {"source": "filter f (image in) in(xy + xy:[50, 0]) end"}
    img = _png_b64(_img(3))
    outs = {}
    for col in ([0, 0, 0, 1], [1, 0, 0, 1]):
        code, body = _post(http_server, "/render", {
            "filter": src, "width": W, "height": H, "format": "raw",
            "inputs": [img], "edge_color": col})
        assert code == 200, body
        outs[str(col)] = np.frombuffer(base64.b64decode(body["data"]), np.uint8)
    assert not np.array_equal(*outs.values())


def test_http_binary_png_and_raw_match_json(http_server):
    src = {"source": "filter f () grayColor(x / W + 0.5) end"}
    base_req = {"filter": src, "width": W, "height": H}
    _, body = _post(http_server, "/render", {**base_req, "png_level": 1})
    code, data, hdr = _post_bytes(http_server, "/render",
                                  {**base_req, "png_level": 1, "binary": True})
    assert code == 200 and hdr["Content-Type"] == "image/png"
    assert data == base64.b64decode(body["image"])
    _, body = _post(http_server, "/render", {**base_req, "format": "raw"})
    code, data, hdr = _post_bytes(http_server, "/render",
                                  {**base_req, "format": "raw", "binary": True})
    assert code == 200
    assert hdr["Content-Type"] == "application/octet-stream"
    assert hdr["X-Shape"] == f"{H},{W},4" and hdr["X-Dtype"] == "uint8"
    assert data == base64.b64decode(body["data"])


def test_http_binary_gif(http_server):
    pytest.importorskip("PIL")
    code, data, hdr = _post_bytes(http_server, "/animate", {
        "filter": {"source": "filter f () grayColor(t) end"},
        "width": W, "height": H, "num_frames": 2, "binary": True})
    assert code == 200 and hdr["Content-Type"] == "image/gif"
    assert data[:6] in (b"GIF87a", b"GIF89a")


def test_http_render_region(http_server):
    img = _img(9)
    base = {"filter": "twirl", "width": W, "height": H, "t": 0.2,
            "params": {"angle": 3.0}, "inputs": [_png_b64(img)]}
    code, full = _post(http_server, "/render", base)
    code_r, reg = _post(http_server, "/render", {**base, "region": [4, 6, 16, 12]})
    assert code == 200 and code_r == 200, (full, reg)
    fa = decode_png(base64.b64decode(full["image"]))
    ra = decode_png(base64.b64decode(reg["image"]))
    assert ra.shape == (12, 16, 4)
    np.testing.assert_array_equal(ra, fa[6:18, 4:20])  # bitwise: a job is its lone render
    code_e, body = _post(http_server, "/render", {**base, "region": [W - 2, 0, 8, 8]})
    assert code_e == 400 and "exceeds" in body["error"]


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    from mathmap_tpu_torch.generators.artifact import export_artifact

    d = tmp_path_factory.mktemp("artifacts")
    f = mt.compile("filter tinted (image in, float gain: 0-2 (1)) in(xy) * gain end")
    export_artifact(f, str(d / "tinted.mmxa"), W, H, params={"gain": 1.0}, device="cpu")
    return d


def test_artifact_serving_http(artifact_dir, service, http_server):
    """/artifacts lists what load_artifacts registered; an artifact /render
    equals the artifact's own render of the decoded request bit for bit
    and the float expectation within the request PNG's quantisation."""
    from mathmap_tpu_torch.generators.artifact import load_artifact

    names = service.load_artifacts(str(artifact_dir))
    assert names == ["tinted"]
    code, body = _get(http_server, "/artifacts")
    assert code == 200 and body["tinted"]["n_inputs"] == 1
    assert body["tinted"]["platforms"] == ["cpu"]
    img = _img(7)
    code, body = _post(http_server, "/render", {
        "artifact": "tinted", "inputs": [_png_b64(img)], "params": {"gain": 0.5},
        "format": "raw"})
    assert code == 200, body
    out = np.frombuffer(base64.b64decode(body["data"]),
                        np.dtype(body["dtype"])).reshape(body["shape"])
    # the artifact renders float32 (no service output_dtype repack)
    assert out.dtype == np.float32
    art = load_artifact(str(artifact_dir / "tinted.mmxa"))
    np.testing.assert_array_equal(
        out, art.render(_request_u8(img), params={"gain": 0.5}).numpy())
    expect = _request_u8(img) / 255.0 * 0.5
    assert np.abs(out[..., :3] - expect[..., :3]).max() < 2 / 255
    code, body = _post(http_server, "/render", {"artifact": "nope", "inputs": [_png_b64(img)]})
    assert code == 400 and "unknown artifact" in body["error"]


def test_artifact_u8_input_normalizes(artifact_dir):
    from mathmap_tpu_torch.generators.artifact import load_artifact

    art = load_artifact(str(artifact_dir / "tinted.mmxa"))
    u8 = (_img(9) * 255).round().astype(np.uint8)
    a = art.render(u8.astype(np.float32) / 255.0, params={"gain": 1.0})
    b = art.render(u8, params={"gain": 1.0})
    assert torch.equal(a, b)
    assert torch.equal(b, art.render(torch.from_numpy(u8), params={"gain": 1.0}))


def _batched_artifact(d, batch_sizes):
    from mathmap_tpu_torch.generators.artifact import export_artifact

    f = mt.compile("filter sc (image in, float gain: 0-2 (1)) in(xy) * gain end")
    export_artifact(f, str(d / "sc.mmxa"), W, H, params={"gain": 1.0},
                    batch_sizes=batch_sizes, device="cpu")
    return d / "sc.mmxa"


def test_artifact_requests_microbatch(tmp_path_factory):
    """Concurrent requests for a batch-exported artifact coalesce into one
    render_batch dispatch, each equal to the lone artifact render."""
    from mathmap_tpu_torch.generators.artifact import load_artifact

    path = _batched_artifact(tmp_path_factory.mktemp("arts_batched"), (4,))
    svc = RenderService(max_batch=8, window_ms=60.0, device="cpu")
    try:
        svc.load_artifacts(str(path.parent))
        art = load_artifact(str(path))
        imgs = [_img(i) for i in range(4)]
        results = _concurrently(4, lambda i: svc.render_artifact(
            "sc", [imgs[i]], params={"gain": 0.25 * (i + 1)}))
        snap = svc.snapshot()
        assert snap["jobs"] == 4
        assert snap["batch_hist"].get("4") == 1, snap
        for i in range(4):
            want = art.render(imgs[i], params={"gain": 0.25 * (i + 1)}).numpy()
            np.testing.assert_array_equal(results[i], want)
    finally:
        svc.shutdown()


def test_artifact_without_batch_programs_singletons(tmp_path_factory):
    from mathmap_tpu_torch.generators.artifact import export_artifact

    d = tmp_path_factory.mktemp("arts_single")
    f = mt.compile("filter g () grayColor(x / W + 0.5) end")
    export_artifact(f, str(d / "g.mmxa"), W, H, device="cpu")
    svc = RenderService(max_batch=8, window_ms=60.0, device="cpu")
    try:
        svc.load_artifacts(str(d))
        outs = [svc.render_artifact("g", []) for _ in range(2)]
        assert svc.snapshot()["dispatches"] == 2  # never grouped
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0].shape == (H, W, 4)
        np.testing.assert_array_equal(outs[0], f.render(width=W, height=H,
                                                        device="cpu").numpy())
    finally:
        svc.shutdown()


def test_artifact_animate_http(tmp_path_factory):
    """/animate with {"artifact": name} runs the exported sweep: raw frames
    (a GIF needs Pillow), F fixed at export."""
    from mathmap_tpu_torch.generators.artifact import export_artifact

    d = tmp_path_factory.mktemp("arts_anim")
    f = mt.compile("filter g () grayColor(t) end")
    export_artifact(f, str(d / "g.mmxa"), W, H, anim_frames=3, device="cpu")
    svc = RenderService(max_batch=8, window_ms=30.0, device="cpu")
    httpd, base = _start(make_handler(svc))
    try:
        svc.load_artifacts(str(d))
        code, body = _post(base, "/animate", {"artifact": "g", "format": "raw"})
        assert code == 200, body
        arr = np.frombuffer(base64.b64decode(body["data"]),
                            np.dtype(body["dtype"])).reshape(body["shape"])
        assert arr.shape == (3, H, W, 4)
        assert arr[0, 0, 0, 0] < arr[2, 0, 0, 0]  # t sweeps 0 -> 2/3
        np.testing.assert_array_equal(arr, f.render_animation(
            num_frames=3, width=W, height=H, device="cpu").numpy())
        code, data, hdr = _post_bytes(base, "/animate", {"artifact": "g", "binary": True})
        assert code == 200 and hdr["Content-Type"] == "image/gif"
        assert data[:6] in (b"GIF87a", b"GIF89a")
        code, body = _post(base, "/animate", {"artifact": "g", "num_frames": 8})
        assert code == 400 and "re-export" in body["error"]
        code, body = _post(base, "/animate", {"artifact": "g", "num_frames": 3,
                                              "format": "raw"})
        assert code == 200, body
        code, body = _post(base, "/render", {"artifact": "g"})
        assert code == 200, body
    finally:
        httpd.shutdown()
        svc.shutdown()


def test_artifact_bad_request_cannot_poison_batch(tmp_path_factory):
    """Requests are validated against the manifest before they are queued:
    a malformed one raises its own ValueError and never joins a group."""
    path = _batched_artifact(tmp_path_factory.mktemp("arts_poison"), (2,))
    svc = RenderService(max_batch=8, window_ms=40.0, device="cpu")
    try:
        svc.load_artifacts(str(path.parent))
        good, bad_errors = [None], []

        def good_client():
            good[0] = svc.render_artifact("sc", [_img(0)], params={"gain": 1.0})

        def bad_client(inputs, params):
            try:
                svc.render_artifact("sc", inputs, params=params)
            except ValueError as e:
                bad_errors.append(str(e))

        ths = [threading.Thread(target=good_client),
               threading.Thread(target=bad_client,
                                args=([np.zeros((4, 4, 4), np.float32)], {"gain": 1.0})),
               threading.Thread(target=bad_client, args=([], {"gain": 1.0})),
               threading.Thread(target=bad_client, args=([_img(1)], {"nope": 2.0}))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
            assert not th.is_alive()
        assert len(bad_errors) == 3, bad_errors
        assert good[0] is not None and good[0].shape == (H, W, 4)
        assert svc.snapshot()["jobs"] == 1
    finally:
        svc.shutdown()


def test_artifact_name_collision_and_reload(tmp_path_factory):
    from mathmap_tpu_torch.generators.artifact import export_artifact

    d1 = tmp_path_factory.mktemp("arts_c1")
    d2 = tmp_path_factory.mktemp("arts_c2")
    f = mt.compile("filter g () grayColor(x / W + 0.5) end")
    export_artifact(f, str(d1 / "g.mmxa"), W, H, device="cpu")
    export_artifact(f, str(d2 / "g.mmxa"), W, H, device="cpu")
    svc = RenderService(max_batch=4, window_ms=10.0, device="cpu")
    try:
        assert svc.load_artifacts(str(d1)) == ["g"]
        assert svc.load_artifacts(str(d1)) == ["g"]  # same-path reload
        with pytest.raises(ValueError, match="already serves"):
            svc.load_artifacts(str(d2))
    finally:
        svc.shutdown()


def test_export_anim_frames_zero_rejected(tmp_path):
    from mathmap_tpu_torch.generators.artifact import export_artifact

    f = mt.compile("filter g () grayColor(t) end")
    with pytest.raises(ValueError, match="anim_frames must be >= 1"):
        export_artifact(f, str(tmp_path / "z.mmxa"), W, H, anim_frames=0, device="cpu")


def test_artifact_routes_name_the_roadmap_item(http_server, service):
    """Once refused naming ROADMAP A10: the artifact routes answer, and an
    unknown artifact is the client's error (400, ValueError)."""
    code, body = _post(http_server, "/render", {"artifact": "nope", "inputs": []})
    assert code == 400 and "unknown artifact" in body["error"]
    code, body = _post(http_server, "/animate", {"artifact": "nope"})
    assert code == 400 and "unknown artifact" in body["error"]
    code, body = _get(http_server, "/artifacts")
    assert code == 200 and isinstance(body, dict)
    for call in (lambda: service.render_artifact("nope", []),
                 lambda: service.animate_artifact("nope", [])):
        with pytest.raises(ValueError, match="unknown artifact"):
            call()
    with pytest.raises(FileNotFoundError):
        service.load_artifacts("no_such_dir/x.mmxa")


def test_service_device_switch(monkeypatch):
    monkeypatch.setenv("MMTPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MMTPU_PLATFORM"):
        RenderService()
    monkeypatch.delenv("MMTPU_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            RenderService()
    monkeypatch.setenv("MMTPU_PLATFORM", "cpu")
    svc = RenderService()
    try:
        assert svc.platform == "cpu"
    finally:
        svc.shutdown()


def test_one_render_matches_the_jax_service():
    """The same /render request to the JAX package's service (its jit path
    on the CPU) and to the port's: within 1 u8 level."""
    from mathmap_tpu.serve import RenderService as RefService
    from mathmap_tpu.serve import make_handler as ref_handler

    req = {"filter": "twirl", "width": W, "height": H, "t": 0.2,
           "params": {"angle": 3.0}, "inputs": [_png_b64(_img(5))], "format": "raw"}
    ref_svc = RefService(max_batch=4, window_ms=4.0)
    port_svc = RenderService(max_batch=4, window_ms=4.0, device="cpu")
    servers = [_start(ref_handler(ref_svc)), _start(make_handler(port_svc))]
    try:
        (rc, want), (pc, got) = [_post(base, "/render", req) for _, base in servers]
    finally:
        for httpd, _ in servers:
            httpd.shutdown()
        ref_svc.shutdown()
        port_svc.shutdown()
    assert rc == pc == 200, (want, got)
    assert got["shape"] == want["shape"] and got["dtype"] == want["dtype"] == "uint8"
    a = np.frombuffer(base64.b64decode(got["data"]), np.uint8).astype(int)
    b = np.frombuffer(base64.b64decode(want["data"]), np.uint8).astype(int)
    assert np.abs(a - b).max() <= 1
