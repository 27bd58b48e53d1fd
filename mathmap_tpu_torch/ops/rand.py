"""The counter-based hash behind every rand() draw (the port of the NumPy
branch of the reference's `Evaluator.rand_uniform` and `_mix_salt`).

A draw is a pure function of the pixel's GLOBAL linear index
`(row_offset + i) * width + (col_offset + j)`, the render's seed, the
draw's counter and, inside a while loop, the iteration salt. So tiled,
sharded and unsharded renders draw the same value at every pixel, and the
CPU, the card's eager ops and kernel B3 (`mm_rand` in
csrc/while_loop.cu.tmpl, with these constants) agree bit for bit.

The reference hashes in uint32, which wraps. Torch's uint32 arithmetic is
partial, so the grid part runs in int64, masked to 32 bits after every step
whose result can pass 2^32. A constant above 2^31 multiplies as its
negative 32-bit representative, so no int64 product can overflow
(|v * c| <= (2^32 - 1) * 2^31 < 2^63) and the mask keeps the low 32 bits,
which are the same for both representatives. The scalar parts (the salts)
are Python ints, exact at any size, except inside a loop that an exported
program runs as torch's while loop (runtime/tracer.py): there the iteration
number, and so a loop salt, is a 0-d int64 tensor in [0, 2^32), which takes
the grid's masked int64 steps and gives the same value as the int.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
#: the seed's and the loop salt's multiplier (2^32 / golden ratio)
GOLDEN = 0x9E3779B9
#: the draw counter's multiplier
COUNTER = 0x85EBCA6B
#: the two multiplies of the finaliser
MIX1 = 0x7FEB352D
MIX2 = 0x846CA68B


def draw_salt(seed: int, counter: int) -> int:
    """The salt of the draw numbered `counter` under `seed`."""
    return (seed * GOLDEN + counter * COUNTER) & M32


def mix_salt(outer, inner):
    """A nested loop's iteration salt: the enclosing loop's salt `outer`
    combined with this loop's iteration number `inner` (either may be a
    0-d int64 tensor below 2^32; then so is the salt)."""
    return (_mul32(outer, GOLDEN) + inner) & M32


def rand_index(shape, width: int, row_offset: int, col_offset: int, device) -> torch.Tensor:
    """The (h, w) int64 grid of global linear pixel indices, mod 2^32."""
    h, w = shape
    iy = torch.arange(row_offset, row_offset + h, dtype=torch.int64, device=device)
    ix = torch.arange(col_offset, col_offset + w, dtype=torch.int64, device=device)
    return (iy[:, None] * width + ix[None, :]) & M32


def _mul32(v, c: int):
    """v * c mod 2^32 for v in [0, 2^32): an int, or a tensor held in
    int64."""
    if not isinstance(v, torch.Tensor):
        return (v * c) & M32
    return (v * (c - (1 << 32) if c >> 31 else c)) & M32


def rand_uniform(index: torch.Tensor, salt: int, salt_extra=None) -> torch.Tensor:
    """One draw in [0, 1) at every pixel of `index` (rand_index()): the
    draw's `salt` (draw_salt()), then the loop's iteration salt (an int or
    a 0-d int64 tensor), then three xorshift-multiply rounds; the top 24
    bits as float32 times 2^-24."""
    v = index ^ salt
    if salt_extra is not None:
        v = v ^ _mul32(salt_extra, GOLDEN)
    v = v ^ (v >> 16)
    v = _mul32(v, MIX1)
    v = v ^ (v >> 15)
    v = _mul32(v, MIX2)
    v = v ^ (v >> 16)
    # v >> 8 < 2^24: exact in float32, as the reference's int32 cast is
    return (v >> 8).to(torch.float32) * (1.0 / 16777216.0)
