"""Host-side image I/O: RGBA float <-> uint8 and image files (the port of
`mathmap_tpu/imgio/images.py`).

PNG is read by `png.decode_png` and written by `png.encode_png` (stdlib
zlib and numpy) on every machine, so the CLI and the service take and give
PNGs where Pillow is not installed. PAM (P7) and PPM (P6) go through the
pure-Python readers and writers below. Every other format (JPEG, GIF, a
PNG outside decode_png's contract) goes through Pillow where it is
installed and otherwise raises the reference's "Pillow is required"
RuntimeError: an I/O dependency, not a change of device.

Arrays may be numpy arrays or torch tensors on any device (a tensor is
copied to the host first).
"""

from __future__ import annotations

import io
import os

import numpy as np

from .png import PNGUnsupported, decode_png, encode_png, is_png

_PNM = (".ppm", ".pam", ".pnm")


def _pil():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError("Pillow is required for image file I/O") from exc
    return Image


def _host(arr) -> np.ndarray:
    """A numpy view of `arr`; a torch tensor is copied to the host."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr)


def to_float_rgba(arr) -> np.ndarray:
    """uint8 (H,W,{1,3,4}) or float array -> float32 (H,W,4) in [0,1]. u8
    becomes u8/255 in float32 (the render's own conversion)."""
    arr = _host(arr)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / np.float32(255.0)
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    if arr.shape[2] == 3:
        alpha = np.ones(arr.shape[:2] + (1,), np.float32)
        arr = np.concatenate([arr, alpha], axis=2)
    if arr.shape[2] != 4:
        raise ValueError(f"expected 1/3/4 channels, got {arr.shape[2]}")
    return arr


def to_uint8(arr) -> np.ndarray:
    """float (H,W,4) in [0,1] -> uint8 with the reference's round-to-nearest
    8-bit packing: clip, x255 + 0.5, truncate. uint8 passes through (a
    render with output_dtype='uint8' was packed on the device by the same
    rule)."""
    arr = _host(arr)
    if arr.dtype == np.uint8:
        return arr
    arr = np.clip(np.asarray(arr, dtype=np.float32), 0.0, 1.0)
    return (arr * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)


def _read_pam(f, path: str):
    """PAM header after the magic -> (width, height, depth)."""
    hdr = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"truncated PAM header: {path}")
        tok = line.split()
        if not tok or tok[0] == b"#":
            continue
        if tok[0] == b"ENDHDR":
            break
        hdr[tok[0]] = tok[1] if len(tok) > 1 else b""
    w, h = int(hdr[b"WIDTH"]), int(hdr[b"HEIGHT"])
    depth = int(hdr.get(b"DEPTH", b"4"))
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and depth in (3, 4)):
        raise ValueError(f"bad PAM header dims {w}x{h}x{depth}: {path}")
    if int(hdr.get(b"MAXVAL", b"255")) != 255:
        raise ValueError(f"PAM MAXVAL must be 255: {path}")
    return w, h, depth


def _read_ppm(f, path: str):
    """P6 header after the magic -> (width, height, 3): width, height and
    maxval separated by whitespace (comments skipped); the line holding
    maxval ends the header."""
    fields = []
    while len(fields) < 3:
        line = f.readline()
        if not line:
            raise ValueError(f"truncated PPM header: {path}")
        fields += line.split(b"#", 1)[0].split()
    w, h, maxv = (int(v) for v in fields[:3])
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20) or maxv != 255:
        raise ValueError(f"bad PPM header {w}x{h} maxval {maxv}: {path}")
    return w, h, 3


def _pnm_header(f, path: str):
    """The header of a binary PAM (P7) or PPM (P6) file open at its start
    -> (width, height, depth), the file left at the pixel data."""
    magic = f.readline().strip()
    if magic == b"P7":
        return _read_pam(f, path)
    if magic[:2] == b"P6":
        if len(magic) > 2:  # "P6 w h 255" on one line
            f.seek(2)
        return _read_ppm(f, path)
    raise ValueError(f"not a binary PAM or PPM file: {path}")


def read_pnm(path: str) -> np.ndarray:
    """A binary PAM (P7, depth 3 or 4) or PPM (P6) file -> uint8 (H, W, 4)."""
    with open(path, "rb") as f:
        w, h, depth = _pnm_header(f, path)
        raw = np.frombuffer(f.read(w * h * depth), np.uint8)
    if raw.size != w * h * depth:
        raise ValueError(f"truncated PAM/PPM pixel data: {path}")
    arr = raw.reshape(h, w, depth)
    if depth == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return arr


def image_size(path: str) -> tuple:
    """(width, height) of an image file from its header alone: a PNG's
    IHDR, a PAM or PPM header, else Pillow's lazy open."""
    if path.lower().endswith(_PNM):
        with open(path, "rb") as f:
            return _pnm_header(f, path)[:2]
    with open(path, "rb") as f:
        head = f.read(24)
    if is_png(head) and head[12:16] == b"IHDR":
        return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
    with _pil().open(path) as im:
        return im.size


def _decode_bytes(data: bytes) -> np.ndarray:
    """One still image's bytes -> uint8 (H, W, 4): PNG by decode_png, the
    rest (and PNGs outside its contract) by Pillow."""
    if is_png(data):
        try:
            return decode_png(data)
        except PNGUnsupported:
            pass
    return np.asarray(_pil().open(io.BytesIO(data)).convert("RGBA"))


def read_image(path: str) -> np.ndarray:
    """Read an image file -> float32 (H,W,4) RGBA in [0,1]."""
    if path.lower().endswith(_PNM):
        return to_float_rgba(read_pnm(path))
    with open(path, "rb") as f:
        return to_float_rgba(_decode_bytes(f.read()))


def read_animation(file, as_uint8: bool = False) -> np.ndarray:
    """Read a multi-frame image file (animated GIF) -> float32 (T, H, W, 4)
    stack for ANIMATED inputs. `file` is a path or a file-like object.
    A PNG, PAM or PPM is one frame, (1, H, W, 4). Multi-frame files whose
    frames disagree in size keep only the frames of frame 0's geometry.
    as_uint8=True returns the decoded (T, H, W, 4) uint8 (the renders
    convert u8 on the device, so a u8 stack ships 4x fewer bytes)."""
    if isinstance(file, (str, os.PathLike)) and str(file).lower().endswith(_PNM):
        frames = read_pnm(str(file))[None]
    else:
        if isinstance(file, (str, os.PathLike)):
            with open(file, "rb") as f:
                data = f.read()
        else:
            data = file.read()
        frames = _decode_frames(data)
    if as_uint8:
        return frames
    return np.stack([to_float_rgba(f) for f in frames])


def _decode_frames(data: bytes) -> np.ndarray:
    if is_png(data):
        try:
            return decode_png(data)[None]
        except PNGUnsupported:
            pass
    img = _pil().open(io.BytesIO(data))
    frames = []
    try:
        i = 0
        while True:
            img.seek(i)
            f = np.asarray(img.convert("RGBA"))
            if not frames or f.shape == frames[0].shape:
                frames.append(f)
            i += 1
    except EOFError:
        pass
    return np.stack(frames)


def encode_gif(frames, fps: float = 25.0, palette: bool = True, disposal: int = 2) -> bytes:
    """An (F, H, W, 4) sequence -> animated GIF bytes through Pillow (or
    the "Pillow is required" RuntimeError). palette=True quantises each
    RGBA frame with .convert("P") first, as write_animation does."""
    frames = _host(frames)
    if frames.ndim != 4 or frames.shape[0] == 0:
        raise ValueError(
            f"write_animation needs a non-empty (F,H,W,4) sequence, got "
            f"shape {frames.shape}")
    if fps <= 0:
        raise ValueError(f"fps must be > 0, got {fps}")
    pil = _pil()
    imgs = [pil.fromarray(to_uint8(f), "RGBA") for f in frames]
    if palette:
        imgs = [im.convert("P") for im in imgs]
    buf = io.BytesIO()
    opts = dict(disposal=disposal) if disposal is not None else {}
    imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0, **opts)
    return buf.getvalue()


def write_animation(path: str, frames, fps: float = 25.0) -> None:
    """Write an (F, H, W, 4) float sequence as an animated GIF (Pillow)."""
    if not path.lower().endswith(".gif"):
        raise ValueError("write_animation writes .gif files")
    data = encode_gif(frames, fps)
    with open(path, "wb") as f:
        f.write(data)


def write_image(path: str, arr) -> None:
    """Write a float (H,W,4) RGBA array in [0,1] (or uint8) to an image
    file: PNG by encode_png, PAM and PPM by the writers below, anything
    else through Pillow (JPEG drops the alpha)."""
    data = to_uint8(arr)
    lower = path.lower()
    if lower.endswith(".png"):
        png = encode_png(data)
        with open(path, "wb") as f:
            f.write(png)
        return
    if lower.endswith(_PNM):
        h, w = data.shape[:2]
        with open(path, "wb") as f:
            if lower.endswith(".pam"):
                f.write(b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 4\nMAXVAL 255\n"
                        b"TUPLTYPE RGB_ALPHA\nENDHDR\n" % (w, h))
                f.write(np.ascontiguousarray(data).tobytes())
            else:  # P6: RGB, the alpha dropped
                f.write(b"P6\n%d %d\n255\n" % (w, h))
                f.write(np.ascontiguousarray(data[..., :3]).tobytes())
        return
    img = _pil().fromarray(data, mode="RGBA")
    if lower.endswith((".jpg", ".jpeg")):
        img = img.convert("RGB")
    img.save(path)
