"""The share of the render layer's constant uploads that the program's
per-device cache of constants answered, in %: its counter `literal.cached`
(a constant read from the card with no copy) over that counter plus the
count of `mm.sync.literal` spans (a constant, a `t` or a `frame` copied
from the host, a wait on the device), times 100, both over every call of
the process, traced or not, warm-up included. Nothing to read where the
program keeps no `literal.cached`, as a program from before the cache
does."""

from bench_torch.harness import program


def read(r: dict):
    got = program._snapshot()
    if got is None:
        return None
    snap, trace = got
    cached = snap["counters"].get("literal.cached")
    if cached is None:
        return None
    misses = snap["spans"].get(trace.SYNC_PREFIX + "literal", {}).get("count", 0)
    return 100.0 * cached / (cached + misses)
