"""PNG encoding and decoding with the standard library's zlib and numpy
only (the port of `mathmap_tpu/imgio/png.py`, plus a decoder).

`encode_png` is the reference's fast encoder, copied: a fixed Sub (type-1)
row filter computed as one vectorised numpy delta, then one
`zlib.compress` call (level 0 stores the rows unfiltered). `decode_png`
reads what this encoder writes and what common encoders write: bit depth
8, no interlace, colour types 0 (gray), 2 (RGB), 3 (palette), 4
(gray+alpha) and 6 (RGBA), a `tRNS` chunk on types 0, 2 and 3, and all
five row filters. It returns what Pillow's `.convert("RGBA")` gives for
those files, byte for byte. Anything else (16-bit or sub-byte depths,
Adam7 interlace, animated PNG) raises `PNGUnsupported`, so a caller can
hand the file to Pillow instead.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
#: bytes per pixel of each supported colour type at bit depth 8
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGUnsupported(ValueError):
    """A well-formed PNG outside decode_png's contract."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W, 3|4) -> PNG bytes (lossless).

    `level` is the zlib effort 0-9; 0 stores uncompressed (fastest, for
    localhost/LAN responses), 1 (default) matches Pillow-level-1 sizes at
    a fraction of the time. Rows use the Sub filter (left-neighbor delta)
    except at level 0, where filtering is skipped — store mode gains
    nothing from it.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(
            f"encode_png expects uint8 (H, W, 3|4), got {arr.dtype} "
            f"{arr.shape}")
    if not 0 <= int(level) <= 9:
        raise ValueError(f"png level must be 0..9, got {level}")
    h, w, c = arr.shape
    raw = np.ascontiguousarray(arr).reshape(h, w * c)
    if level == 0:
        ftype, rows = 0, raw
    else:
        ftype = 1  # Sub: delta against the pixel to the left (bpp stride)
        rows = raw.copy()
        rows[:, c:] = raw[:, c:] - raw[:, :-c]  # uint8 wraparound == mod 256
    buf = np.empty((h, w * c + 1), np.uint8)
    buf[:, 0] = ftype
    buf[:, 1:] = rows
    idat = zlib.compress(buf.tobytes(), int(level))
    color = 6 if c == 4 else 2  # RGBA / RGB, 8-bit
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def is_png(data: bytes) -> bool:
    return data[:8] == _SIG


def _chunks(data: bytes):
    """(tag, payload) of every chunk up to IEND, CRCs checked."""
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {tag!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG: no IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays (ties go to a, then b)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_run(x: np.ndarray, ftypes: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Undo Average (3) and Paeth (4) rows, which depend on the decoded
    left neighbour, for a run of consecutive such rows: pixel (r, i) needs
    (r, i-1), (r-1, i) and (r-1, i-1), so every anti-diagonal r + i = k is
    one vectorised step over the run. x: (R, W, bpp) int16 filtered bytes;
    prior: (W, bpp) int16, the decoded row above the run."""
    n_rows, w, bpp = x.shape
    out = np.zeros((n_rows + 1, w + 1, bpp), np.int16)  # row 0 = prior, col 0 = 0
    out[0, 1:] = prior
    paeth = (ftypes == 4)
    for k in range(n_rows + w - 1):
        r = np.arange(max(0, k - w + 1), min(n_rows, k + 1))
        i = k - r
        a = out[r + 1, i]        # left
        b = out[r, i + 1]        # up
        c = out[r, i]            # up-left
        pred = np.where(paeth[r, None], _paeth(a, b, c), (a + b) >> 1)
        out[r + 1, i + 1] = (x[r, i] + pred) & 255
    return out[1:, 1:]


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (h, 1 + w*bpp) -> decoded (h, w, bpp) uint8."""
    ftypes = raw[:, 0]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    x = raw[:, 1:].reshape(h, w, bpp).astype(np.int16)
    out = np.empty((h, w, bpp), np.int16)
    prior = np.zeros((w, bpp), np.int16)
    r = 0
    while r < h:
        f = ftypes[r]
        if f in (3, 4):
            end = r
            while end < h and ftypes[end] in (3, 4):
                end += 1
            out[r:end] = _unfilter_run(x[r:end], ftypes[r:end], prior)
            r = end
        else:
            if f == 0:
                out[r] = x[r]
            elif f == 1:
                out[r] = np.cumsum(x[r].astype(np.uint8), axis=0, dtype=np.uint8)
            else:
                out[r] = (x[r] + prior) & 255
            r += 1
        prior = out[r - 1]
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 4) RGBA, as Pillow's .convert("RGBA")
    gives it. Gray repeats to RGB; a missing alpha is 255; tRNS makes the
    one matching gray or RGB value transparent, or gives the palette's
    entries their alpha (255 past the table). Raises PNGUnsupported for a
    PNG outside the contract (see the module docstring) and ValueError for
    a damaged one."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    ihdr = plte = trns = None
    idat = []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"acTL":
            raise PNGUnsupported("animated PNG")
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise ValueError("PNG without a valid IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise PNGUnsupported(
            f"PNG bit depth {depth}, colour type {ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"PNG image data: {exc}") from None
    if len(raw) < h * (1 + w * bpp):
        raise ValueError("truncated PNG image data")
    px = _unfilter(np.frombuffer(raw, np.uint8, h * (1 + w * bpp)).reshape(h, 1 + w * bpp),
                   h, w, bpp)
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("palette PNG without a valid PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        n = min(len(plte) // 3, 256)
        table[:n, :3] = np.frombuffer(plte, np.uint8, n * 3).reshape(n, 3)
        if trns is not None:
            table[:len(trns[:256]), 3] = np.frombuffer(trns[:256], np.uint8)
        return table[px[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
        return out
    out[..., 3] = 255
    if trns is not None:
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns[:len(trns) // 2 * 2]))
        if len(key) == (1 if ctype == 0 else 3):
            match = np.all(px.astype(np.int32) == key, axis=-1)
            out[match, 3] = 0
    return out
