"""The benchmark's PNG codec: its own encoder's files, and rows of every
filter type as other encoders write them."""

import struct
import zlib

import numpy as np

from bench_torch.harness import images


def test_round_trip():
    img = np.random.default_rng(1).integers(0, 256, (37, 53, 4), dtype=np.uint8)
    assert np.array_equal(images.decode_png(images.encode_png(img)), img)


def _filtered(img: np.ndarray, types) -> bytes:
    """A PNG whose row i uses filter types[i % len(types)] (0-4)."""
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    rows = []
    for i in range(h):
        f = types[i % len(types)]
        cur = x[i]
        up = x[i - 1] if i else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_every_row_filter():
    img = np.random.default_rng(2).integers(0, 256, (23, 31, 4), dtype=np.uint8)
    for types in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 2, 1)):
        assert np.array_equal(images.decode_png(_filtered(img, types)), img), types


def test_rgb_reads_as_opaque_rgba():
    img = np.random.default_rng(3).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    got = images.decode_png(_filtered(img, (1, 4)))
    assert np.array_equal(got[..., :3], img) and (got[..., 3] == 255).all()
