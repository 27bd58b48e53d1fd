"""The port's image I/O (mathmap_tpu_torch/imgio/): the stdlib PNG decoder
against Pillow's RGBA decode, which the JAX package's `read_image` uses,
BIT FOR BIT on the uint8 level, for every colour type, the palette with and
without tRNS, gray and RGB tRNS, and each of the five row filters; the
port's encoder round trip; PAM and PPM through both packages; and the
"Pillow is required" RuntimeError for formats that need Pillow when it is
hidden.
"""

import builtins
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from mathmap_tpu.imgio import images as ref_images
from mathmap_tpu_torch.imgio import images
from mathmap_tpu_torch.imgio.png import PNGUnsupported, decode_png, encode_png

Image = pytest.importorskip("PIL.Image")


def _smooth(h, w, c, seed=0):
    """Gradients plus a little noise: every filter type wins somewhere."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * (3 + k) + yy * (k + 1) * 2) % 256 for k in range(c)], -1)
    return (a + rng.randint(0, 24, a.shape)).astype(np.uint8)


def _pillow_png(img, **save) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **save)
    return buf.getvalue()


def _pillow_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _ref_u8(tmp_path, data: bytes) -> np.ndarray:
    """The JAX package's read_image of the file, packed back to u8."""
    p = tmp_path / "ref.png"
    p.write_bytes(data)
    return ref_images.to_uint8(ref_images.read_image(str(p)))


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("save", [{}, {"compress_level": 9}, {"optimize": True},
                                  {"compress_level": 0}], ids=["default", "l9", "opt", "l0"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_matches_pillow_for_each_colour_type(tmp_path, mode, save):
    a = _smooth(37, 53, MODES[mode])
    img = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
    data = _pillow_png(img, **save)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 4)
    np.testing.assert_array_equal(got, _pillow_rgba(data))
    np.testing.assert_array_equal(got, _ref_u8(tmp_path, data))


@pytest.mark.parametrize("trns", [None, "bytes", "short", "index"])
def test_decode_matches_pillow_for_palettes(tmp_path, trns):
    a = _smooth(40, 61, 3, seed=1)
    p = Image.fromarray(a, "RGB").convert("P", palette=Image.Palette.ADAPTIVE, colors=50)
    save = {}
    if trns == "bytes":      # one alpha for every entry
        save["transparency"] = bytes(range(0, 250, 5))
    elif trns == "short":    # alphas for the first entries only
        save["transparency"] = bytes([0, 64, 128, 200])
    elif trns == "index":    # one fully transparent entry
        save["transparency"] = 3
    data = _pillow_png(p, **save)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pillow_rgba(data))
    np.testing.assert_array_equal(got, _ref_u8(tmp_path, data))
    if trns is not None:
        assert (got[..., 3] < 255).any()


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_decode_matches_pillow_for_gray_and_rgb_trns(mode):
    a = _smooth(20, 30, 3 if mode == "RGB" else 1, seed=2)
    img = Image.fromarray(a if mode == "RGB" else a[..., 0], mode)
    key = tuple(int(v) for v in a[3, 4]) if mode == "RGB" else int(a[3, 4, 0])
    data = _pillow_png(img, transparency=key)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pillow_rgba(data))
    assert got[3, 4, 3] == 0


def _png_with_filter(arr: np.ndarray, ftypes) -> bytes:
    """A PNG whose rows use the given filter types (0-4), written from the
    PNG specification's definitions (scalar Python, independent of the
    decoder)."""
    h, w, c = arr.shape
    raw = arr.reshape(h, w * c).astype(int)
    out = bytearray()
    for r in range(h):
        f = ftypes[r % len(ftypes)]
        out.append(f)
        for i in range(w * c):
            x = raw[r, i]
            a = raw[r, i - c] if i >= c else 0
            b = raw[r - 1, i] if r else 0
            cc = raw[r - 1, i - c] if r and i >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((x - pred) % 256)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [4, 3, 3, 1, 4, 2, 0, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decode_each_row_filter(ftypes, channels):
    a = _smooth(17, 23, channels, seed=3)
    # saturate a corner so Paeth ties and wraparounds occur
    a[:4, :4] = 255
    a[5:8, 5:9] = 0
    data = _png_with_filter(a, ftypes)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pillow_rgba(data))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("channels", [3, 4])
def test_encode_decode_round_trip(level, channels):
    a = (np.random.RandomState(level + channels).rand(19, 33, channels) * 255).astype(np.uint8)
    data = encode_png(a, level)
    got = decode_png(data)
    np.testing.assert_array_equal(got[..., :channels], a)
    if channels == 3:
        assert (got[..., 3] == 255).all()
    np.testing.assert_array_equal(got, _pillow_rgba(data))


def test_encode_matches_the_reference_encoder():
    from mathmap_tpu.imgio.png import encode_png as ref_encode

    a = _smooth(31, 45, 4, seed=4)
    for level in (0, 1, 9):
        assert encode_png(a, level) == ref_encode(a, level)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(a, level=10)


def test_decode_refuses_what_it_does_not_cover():
    big = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(PNGUnsupported):
        decode_png(_pillow_png(big))
    bilevel = Image.fromarray(np.eye(8, dtype=bool))
    with pytest.raises(PNGUnsupported):
        decode_png(_pillow_png(bilevel))
    good = encode_png(_smooth(4, 4, 4))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError):
        decode_png(b"GIF89a...")


def test_read_image_routes_outside_the_contract_to_pillow(tmp_path):
    p = tmp_path / "i16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900).save(p)
    np.testing.assert_array_equal(images.read_image(str(p)), ref_images.read_image(str(p)))


def test_read_write_png_match_the_reference(tmp_path):
    f = np.random.RandomState(5).rand(12, 17, 4).astype(np.float32)
    p = str(tmp_path / "a.png")
    images.write_image(p, f)
    got = images.read_image(p)
    want = ref_images.read_image(p)
    np.testing.assert_array_equal(ref_images.to_uint8(got), ref_images.to_uint8(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(images.to_uint8(got), ref_images.to_uint8(f))
    # tensors, on any device, write like arrays
    q = str(tmp_path / "b.png")
    images.write_image(q, torch.from_numpy(f))
    assert open(p, "rb").read() == open(q, "rb").read()


@pytest.mark.parametrize("ext", ["pam", "ppm"])
def test_pam_and_ppm_through_both_packages(tmp_path, ext):
    f = np.random.RandomState(6).rand(9, 14, 4).astype(np.float32)
    mine, theirs = str(tmp_path / f"mine.{ext}"), str(tmp_path / f"ref.{ext}")
    images.write_image(mine, f)
    ref_images.write_image(theirs, f)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for path in (mine, theirs):
        a, b = images.read_image(path), ref_images.read_image(path)
        np.testing.assert_array_equal(images.to_uint8(a), ref_images.to_uint8(b))
    assert images.image_size(mine) == (14, 9)
    stack = images.read_animation(mine, as_uint8=True)
    assert stack.shape == (1, 9, 14, 4) and stack.dtype == np.uint8


def test_ppm_header_with_comments_and_one_line(tmp_path):
    rgb = (np.random.RandomState(7).rand(3, 5, 3) * 255).astype(np.uint8)
    for header in (b"P6\n# a comment\n5 3\n255\n", b"P6 5 3 255\n"):
        p = tmp_path / "c.ppm"
        p.write_bytes(header + rgb.tobytes())
        got = images.read_pnm(str(p))
        np.testing.assert_array_equal(got[..., :3], rgb)
        assert images.image_size(str(p)) == (5, 3)


def test_to_float_and_to_uint8_follow_the_reference_rules():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    f = images.to_float_rgba(u8)
    assert f.shape == (16, 16, 4) and (f[..., 3] == 1).all()
    np.testing.assert_array_equal(f[..., :3], u8.astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(images.to_uint8(f), ref_images.to_uint8(f))
    x = np.linspace(-0.5, 1.5, 4001, dtype=np.float32).reshape(1, -1, 1).repeat(4, -1)
    np.testing.assert_array_equal(images.to_uint8(x), ref_images.to_uint8(x))


def test_image_size_reads_only_the_header(tmp_path):
    p = tmp_path / "s.png"
    p.write_bytes(encode_png(_smooth(7, 11, 4))[:40])  # header only, no pixels
    assert images.image_size(str(p)) == (11, 7)


@pytest.fixture
def no_pillow(monkeypatch):
    real_import = builtins.__import__

    def fake_import(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("hidden for the test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", fake_import)


def test_gif_needs_pillow(tmp_path, no_pillow):
    frames = np.random.RandomState(8).rand(2, 6, 6, 4).astype(np.float32)
    with pytest.raises(RuntimeError, match="Pillow is required"):
        images.write_animation(str(tmp_path / "x.gif"), frames)
    with pytest.raises(RuntimeError, match="Pillow is required"):
        images.read_animation(io.BytesIO(b"GIF89a" + bytes(40)))
    with pytest.raises(RuntimeError, match="Pillow is required"):
        images.write_image(str(tmp_path / "x.jpg"), frames[0])


def test_png_pam_ppm_work_without_pillow(tmp_path, no_pillow):
    f = np.random.RandomState(9).rand(6, 7, 4).astype(np.float32)
    for ext in ("png", "pam", "ppm"):
        p = str(tmp_path / f"x.{ext}")
        images.write_image(p, f)
        got = images.read_image(p)
        n = 4 if ext != "ppm" else 3
        np.testing.assert_array_equal(images.to_uint8(got)[..., :n], images.to_uint8(f)[..., :n])
    stack = images.read_animation(io.BytesIO(encode_png(images.to_uint8(f))), as_uint8=True)
    assert stack.shape == (1, 6, 7, 4)


def test_gif_round_trip_with_pillow(tmp_path):
    frames = np.zeros((3, 8, 8, 4), np.float32)
    for i in range(3):
        frames[i, ..., i] = 1.0
        frames[i, ..., 3] = 1.0
    p = str(tmp_path / "a.gif")
    images.write_animation(p, frames, fps=10)
    got = images.read_animation(p, as_uint8=True)
    want = ref_images.read_animation(p, as_uint8=True)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 8, 8, 4)
    with pytest.raises(ValueError):
        images.write_animation(str(tmp_path / "a.png"), frames)
