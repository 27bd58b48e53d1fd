"""The port's preview server (mathmap_tpu_torch/preview.py) on the CPU,
case for case with tests/test_preview.py: the pages, the library, /render
(params, a curve LUT, a region composited in place, a two-input filter),
/upload (PNG, and a GIF that becomes an animated input), /animate,
/sweep, the composer endpoints and the error responses.

Upload PNGs are written with the port's `imgio/png.encode_png` (the card
has no Pillow); the animated GIF with Pillow, which decoding it needs.
Rendered frames are held against the JAX package's NumPy oracle
(`interpret=True`) within 1 u8 level, and against the port's own render
bit for bit.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu_torch.imgio.images import to_uint8
from mathmap_tpu_torch.imgio.png import decode_png, encode_png
from mathmap_tpu_torch.preview import PreviewState, _make_handler


def _serve(state):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    img = np.zeros((16, 16, 4), np.float32)
    img[..., 3] = 1.0
    srv, base = _serve(PreviewState(img, 16, mt.default_db(), device="cpu"))
    yield base
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _png(b64) -> np.ndarray:
    return decode_png(base64.b64decode(b64))


def _within_one_level(got, want):
    assert got.shape == want.shape
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_page_and_library(server):
    page = _get(server + "/").decode()
    assert "mathmap_tpu_torch preview" in page
    lib = json.loads(_get(server + "/library"))
    assert "Distorts" in lib and "fisheye" in lib["Distorts"]
    src = _get(server + "/filter/twirl").decode()
    assert "filter twirl" in src


def test_render_roundtrip_with_params(server):
    src = "filter f (float k: 0-1 (0.25)) grayColor(k) end"
    out = _post(server + "/render", {"source": src, "t": 0.0, "params": {}})
    assert "png" in out and len(out["png"]) > 100
    assert out["params"][0]["name"] == "k"
    out2 = _post(server + "/render", {"source": src, "t": 0.0, "params": {"k": 0.9}})
    assert out2["png"] != out["png"]
    want = np.asarray(mm.compile(src).render(width=16, height=16, params={"k": 0.9},
                                             interpret=True))
    _within_one_level(_png(out2["png"]), to_uint8(want))


def test_render_error_reported(server):
    out = _post(server + "/render", {"source": "grayColor(1 +", "t": 0.0})
    assert "error" in out and "MMSyntaxError" in out["error"]


def test_upload_endpoint(server):
    """An upload replaces the input (the drawable-selection analog)."""
    img = (np.random.RandomState(4).rand(20, 30, 4) * 255).astype(np.uint8)
    out = _post(server + "/upload", {"data": base64.b64encode(encode_png(img)).decode()})
    assert out == {"width": 30, "height": 20}
    r = _post(server + "/render", {"source": "origVal(xy)", "t": 0.0})
    assert (r["width"], r["height"]) == (30, 20)
    np.testing.assert_array_equal(_png(r["png"]), img)  # identity: the upload's bytes


def test_upload_animated_gif_becomes_animated_input(server):
    """A multi-frame GIF upload is an ANIMATED (T, H, W, 4) input; the
    animate endpoint maps input frames to output frames."""
    pil = pytest.importorskip("PIL.Image")
    frames = [pil.fromarray(np.full((12, 18, 4), 30 + 180 * i, np.uint8), "RGBA").convert("P")
              for i in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=100, loop=0)
    out = _post(server + "/upload", {"data": base64.b64encode(buf.getvalue()).decode()})
    assert out == {"width": 18, "height": 12}
    out = _post(server + "/animate", {"source": "origVal(xy)", "frames": 2})
    assert len(out["frames"]) == 2
    assert out["frames"][0] != out["frames"][1]


def test_animate_endpoint(server):
    out = _post(server + "/animate", {"source": "grayColor(t)", "frames": 4})
    assert len(out["frames"]) == 4
    assert out["frames"][0] != out["frames"][-1]
    for i, b64 in enumerate(out["frames"]):  # frame i at t = i/4
        assert np.all(_png(b64)[..., :3] == int(np.floor(i / 4 * 255 + 0.5)))


def test_curve_lut_param_render(server):
    """A freehand-curve LUT (a list of floats) flows through params."""
    lut = [min(1.0, i / 16) for i in range(64)]
    src = "filter f (curve cv) grayColor(cv((x + X) / W)) end"
    out = _post(server + "/render", {"source": src, "params": {"cv": lut}})
    assert "png" in out and not out.get("error")
    want = np.asarray(mm.compile(src).render(width=16, height=16,
                                             params={"cv": np.asarray(lut, np.float32)},
                                             interpret=True))
    _within_one_level(_png(out["png"]), to_uint8(want))


def test_composer_page_and_palette(server):
    page = _get(server + "/composer").decode()
    assert "Composer" in page and "addNode" in page
    pal = json.loads(_get(server + "/palette"))
    assert "twirl" in pal
    assert any(p["kind"] == "image" for p in pal["twirl"]["params"])


GRAPH = {
    "nodes": [
        {"id": "a", "filter": "grayscale", "params": {"in": {"input": 0}}},
        {"id": "b", "filter": "twirl", "params": {"in": {"ref": "a"}, "angle": 5.0}},
    ],
    "output": "b",
}


def test_compose_endpoint_renders_graph(server):
    out = _post(server + "/compose", GRAPH)
    assert not out.get("error"), out.get("error")
    assert "filter composed" in out["source"] and "img_b(xy)" in out["source"]
    assert "png" in out
    mmc = _post(server + "/compose_mmc", GRAPH)
    assert "(composer" in mmc["mmc"] and '"twirl"' in mmc["mmc"]


def test_compose_cycle_error(server):
    req = {
        "nodes": [
            {"id": "a", "filter": "twirl", "params": {"in": {"ref": "b"}}},
            {"id": "b", "filter": "twirl", "params": {"in": {"ref": "a"}}},
        ],
        "output": "b",
    }
    out = _post(server + "/compose", req)
    assert "cycle" in out.get("error", "")


def test_parse_mmc_roundtrip(server):
    mmc = _post(server + "/compose_mmc", GRAPH)["mmc"]
    g = _post(server + "/parse_mmc", {"mmc": mmc})
    assert not g.get("error"), g.get("error")
    assert g["output"] == "b"
    by_id = {n["id"]: n for n in g["nodes"]}
    assert by_id["b"]["filter"] == "twirl"
    assert by_id["b"]["params"]["in"] == {"ref": "a"}
    assert by_id["b"]["params"]["angle"] == 5.0
    assert by_id["a"]["params"]["in"] == {"input": 0}
    assert by_id["b"]["x"] > by_id["a"]["x"]
    bad = _post(server + "/parse_mmc", {"mmc": "(not-composer)"})
    assert "composer" in bad.get("error", "")


def test_render_multi_image_filter(server):
    """A two-input filter binds the uploaded drawable to EVERY image param."""
    data = _post(server + "/render", {
        "source": "filter blend2 (image a, image b) lerp(0.5, a(xy), b(xy)) end",
        "t": 0.0, "params": {}})
    assert "png" in data, data


def test_bad_json_returns_error_response(server):
    req = urllib.request.Request(server + "/render", b"{not json", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read()
    except urllib.error.HTTPError as e:
        body = e.read()
    assert "error" in json.loads(body)


SWEEP_SRC = ("filter tw (image in, float angle: 0-10 (3))\n"
             "  in(toXY(ra:[r, a + angle * (1 - r / R)]))\nend")


def test_sweep_endpoint():
    """/sweep: N param steps over the one drawable in one render_batch call;
    each frame is the lone render at its value, and bad specs come back as
    readable errors. Own server: the module fixture's input is replaced by
    the upload tests."""
    img = np.random.RandomState(2).rand(16, 20, 4).astype(np.float32)
    img[..., 3] = 1.0
    srv, base = _serve(PreviewState(img, 16, mt.default_db(), device="cpu"))
    try:
        out = _post(base + "/sweep", {"source": SWEEP_SRC, "param": "angle", "lo": 0.0,
                                      "hi": 6.0, "frames": 3})
        assert "error" not in out, out.get("error")
        assert len(out["frames"]) == 3
        assert out["frames"][0] != out["frames"][2]
        f = mt.compile(SWEEP_SRC)
        for b64, angle in zip(out["frames"], (0.0, 3.0, 6.0)):
            lone = f.render(img, params={"angle": angle}, frame=0.0, device="cpu")
            np.testing.assert_array_equal(_png(b64)[..., :3], to_uint8(lone)[..., :3])
        out = _post(base + "/sweep", {"source": SWEEP_SRC, "param": "nosuch", "lo": 0.0,
                                      "hi": 1.0, "frames": 2})
        assert "no such param" in out["error"] and "Traceback" not in out["error"]
        out = _post(base + "/sweep", {"source": "filter g (image in, color c) in(xy) * c end",
                                      "param": "c", "lo": 0.0, "hi": 1.0, "frames": 2})
        assert "only float/int" in out["error"]
    finally:
        srv.shutdown()


def test_render_region_composites_in_place():
    """region=[x, y, w, h]: the filter is applied to the selection only and
    composited in place; inside it equals the full render's crop, outside
    it is the drawable's bytes."""
    rng = np.random.RandomState(8)
    img = rng.rand(24, 32, 4).astype(np.float32)
    img[..., 3] = 1.0
    srv, base = _serve(PreviewState(img, 24, mt.default_db(), device="cpu"))
    try:
        src = "origVal(xy + xy:[0, 2 * sin(x / 3)])"
        full = _post(base + "/render", {"source": src, "t": 0.0})
        reg = _post(base + "/render", {"source": src, "t": 0.0, "region": [5, 3, 12, 10]})
        assert not reg.get("error"), reg.get("error")
        assert (reg["width"], reg["height"]) == (32, 24)
        got, want = _png(reg["png"]), _png(full["png"])
        np.testing.assert_array_equal(got[3:13, 5:17], want[3:13, 5:17])
        _within_one_level(want, to_uint8(np.asarray(mm.compile(src).render(
            img, interpret=True))))
        bg = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        mask = np.zeros((24, 32, 1), bool)
        mask[3:13, 5:17] = True
        np.testing.assert_array_equal(np.where(mask, bg, got), bg)
        bad = _post(base + "/render", {"source": src, "t": 0.0, "region": [30, 0, 10, 4]})
        assert "exceeds" in bad.get("error", "")
    finally:
        srv.shutdown()


def test_the_state_renders_on_its_device_and_the_switch_is_explicit(monkeypatch):
    """PreviewState takes the front ends' device: the CPU only when asked
    (device="cpu" or MMTPU_PLATFORM=cpu)."""
    import torch

    monkeypatch.setenv("MMTPU_PLATFORM", "cpu")
    assert PreviewState(None, 8, mt.default_db()).device == torch.device("cpu")
    monkeypatch.setenv("MMTPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MMTPU_PLATFORM"):
        PreviewState(None, 8, mt.default_db())
    monkeypatch.delenv("MMTPU_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            PreviewState(None, 8, mt.default_db())
