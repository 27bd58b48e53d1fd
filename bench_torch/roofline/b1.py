"""Kernel B1, the origVal sampler (`sample_image_kernel`).

A launch reads its source image and the output grid's two float32
coordinate fields once, and writes four float32 output planes once; the
least time is those bytes over the HBM rate (its operations, ~54 an
output pixel, take far less)."""

KERNEL = "sample_image_kernel"
COORD_BYTES = 2 * 4
OUT_BYTES = 4 * 4


def launch_bytes(out_h: int, out_w: int, in_h: int, in_w: int, in_itemsize: int) -> int:
    return int(in_h) * int(in_w) * 4 * int(in_itemsize) + int(out_h) * int(out_w) * (
        COORD_BYTES + OUT_BYTES)
