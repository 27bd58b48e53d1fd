"""Input images made from the seed, and the benchmark's own PNG codec.

`smooth_image` is the acceptance script's smooth seeded image (a 9x6 grid
of random colours, bilinearly interpolated and faded to transparent black
at the border), made on the device: a render on the card and its plain
reference compute the warp's coordinates with their own rounding, and an
image that changes by at most ~0.008 a pixel keeps that from turning into
output differences. `textured` adds a seeded per-pixel texture of a few
levels, so that a PNG of it compresses like a photograph and not like a
gradient.

The PNG codec is independent of the program's: `encode_png` writes 8-bit
RGBA with the Sub filter on every row; `decode_png` reads 8-bit RGB or
RGBA without interlace and with any of the five row filters (rows of the
Average or Paeth filter go through an anti-diagonal sweep, which keeps it
vectorised).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SIG = b"\x89PNG\r\n\x1a\n"


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def smooth_image(w: int, h: int, seed: int, device: torch.device,
                 fade: bool = True) -> torch.Tensor:
    """(h, w, 4) uint8 on `device`: the seed's 6x9 grid of colours,
    interpolated bilinearly in float64, faded by a sine window, rounded."""
    coarse = torch.from_numpy(np.random.default_rng(seed).random((6, 9, 4))).to(device)
    v = (torch.arange(h, dtype=torch.float64, device=device) + 0.5) * (5 / h)
    u = (torch.arange(w, dtype=torch.float64, device=device) + 0.5) * (8 / w)
    iv, iu = torch.floor(v).long(), torch.floor(u).long()
    fv, fu = (v - iv)[:, None, None], (u - iu)[None, :, None]
    rows = coarse[iv] * (1 - fv) + coarse[iv + 1] * fv
    img = rows[:, iu] * (1 - fu) + rows[:, iu + 1] * fu
    if fade:
        img = img * (torch.sin(torch.pi * v / 5)[:, None, None]
                     * torch.sin(torch.pi * u / 8)[None, :, None])
    return torch.floor(img * 255.0 + 0.5).to(torch.uint8)


def textured(img: torch.Tensor, levels: int, seed: int) -> torch.Tensor:
    """`img` plus a seeded texture of -levels..levels per value, clipped."""
    noise = torch.randint(-levels, levels + 1, img.shape, generator=generator(seed, img.device),
                          device=img.device, dtype=torch.int16)
    return torch.clamp(img.to(torch.int16) + noise, 0, 255).to(torch.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W, 4) -> PNG bytes, every row Sub-filtered."""
    h, w, c = arr.shape
    if arr.dtype != np.uint8 or c != 4:
        raise ValueError("encode_png takes uint8 (H, W, 4)")
    raw = np.ascontiguousarray(arr).reshape(h, w * c)
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:5] = raw[:, :4]
    rows[:, 5:] = raw[:, 4:] - raw[:, :-4]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_sweep(ftype: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """All five filters, pixel by anti-diagonal: pixel (i, j) needs its
    left, upper and upper-left neighbours, which lie on earlier
    diagonals. `raw` is (h, w, bpp) int32, -> the same shape reconstructed."""
    h, w, _ = raw.shape
    out = np.zeros((h + 1, w + 1, raw.shape[2]), np.int32)  # zero row and column
    for d in range(h + w - 1):
        i = np.arange(max(0, d - w + 1), min(h, d + 1))
        j = d - i
        a, b, c = out[i + 1, j], out[i, j + 1], out[i, j]
        f = ftype[i][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) // 2, np.where(f == 4, _paeth(a, b, c), 0))))
        out[i + 1, j + 1] = (raw[i, j] + pred) & 255
    return out[1:, 1:]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, not interlaced) -> uint8 (H, W, 4)."""
    idat = []
    w = h = color = None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or color not in (2, 6) or interlace:
                raise ValueError(f"unsupported PNG: depth {depth}, colour {color}, "
                                 f"interlace {interlace}")
        elif tag == b"IDAT":
            idat.append(body)
    if w is None:
        raise ValueError("PNG without IHDR")
    bpp = 4 if color == 6 else 3
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (w * bpp + 1):
        raise ValueError("PNG data of the wrong length")
    rows = flat.reshape(h, w * bpp + 1)
    ftype, raw = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if ftype.max() > 4:
        raise ValueError("PNG row filter above 4")
    if np.isin(ftype, (3, 4)).any():
        pix = _unfilter_sweep(ftype, raw.astype(np.int32)).astype(np.uint8)
    else:
        pix = np.empty_like(raw)
        prev = np.zeros((w, bpp), np.uint8)
        for i in range(h):
            if ftype[i] == 1:
                prev = np.cumsum(raw[i], axis=0, dtype=np.uint8)
            elif ftype[i] == 2:
                prev = raw[i] + prev
            else:
                prev = raw[i].copy()
            pix[i] = prev
    if bpp == 3:
        pix = np.concatenate([pix, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return pix
