"""Constants kept on their device: a value fixed for the program (a literal
of the filter's text, a frame geometry's offset, an edge colour, the u8
divisor) is uploaded once per (value, dtype, device), and every later use
reads the tensor already there, with no copy and no wait on the device.

`constant(sync, value, dtype, device)` is the one entry. A miss uploads
through `sync.tensor` (utils/trace.py), so it is the caller's
`mm.sync.<cause>` span, a wait like any other; a hit opens no span and adds
1 to the counter `literal.cached`. The key is the value's type and exact
bits (-0.0 and 0.0, or two NaNs of other bits, are two keys; so are an int
and a float), the dtype and the `torch.device`. While torch compiles or
exports a program, the value is uploaded as before and nothing is kept: a
tensor made then is the tracer's, not a real one. Only a plain
`torch.Tensor` is kept, so a fake tensor (FakeTensorMode) never is.

What changes from call to call (`t`, `frame`, params, a loop's scalars)
must not come here: each distinct value is an entry for the life of the
process. The cache holds at most MAX_ENTRIES and is emptied when full,
which bounds a process that renders programs without end (the service,
the designer). A kept tensor is shared by every render that reads the
value: nothing may write into it.
"""

from __future__ import annotations

import struct

import torch
import torch.compiler as _compiler

from .trace import count

#: entries before the cache is emptied: far above the constants of the
#: filters and shapes one process renders
MAX_ENTRIES = 4096

#: (type, the value's bits, dtype, device) -> the tensor on the device
_cache: dict = {}


def exact(value) -> tuple:
    """A number's type and exact bits: -0.0 and 0.0, two NaNs of other
    bits, or an int and a float of one value give two keys."""
    return type(value), value if isinstance(value, int) else struct.pack("<d", float(value))


def _key(value, dtype: torch.dtype, device) -> tuple:
    return (*exact(value), dtype, device)


def constant(sync, value, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)`, uploaded once
    through the span `sync` and read from then on (see the module's
    docstring). The tensor is shared: never write into it."""
    if _compiler._is_compiling_flag:
        return sync.tensor(value, dtype, device)
    key = _key(value, dtype, device)
    got = _cache.get(key)
    if got is not None:
        count("literal.cached")
        return got
    got = sync.tensor(value, dtype, device)
    if type(got) is not torch.Tensor:
        return got
    if len(_cache) >= MAX_ENTRIES:
        _cache.clear()
    # setdefault: a thread that uploaded the same value meanwhile keeps its
    # entry, and this call returns it
    return _cache.setdefault(key, got)


def entries() -> dict:
    """A copy of the cache: {(type, bits, dtype, device): tensor}."""
    return dict(_cache)


def clear() -> None:
    """Empty the cache (the next use of each constant uploads it again)."""
    _cache.clear()
