"""The share of the while loops' probes that the loops' memos answered, in
%: the program's counter `probe.cached` (a loop that found its probe's
outcome, the carried names' lengths and tags, in its memo and ran no
probe) over that counter plus the count of `mm.loop.probe` spans (a probe
that ran: the condition and the body evaluated once over the frame, the
results discarded), times 100, both over every call of the process,
traced or not, warm-up included. Nothing to read where the program keeps
no `probe.cached`, as a program from before the memo does."""

from bench_torch.harness import program


def read(r: dict):
    got = program._snapshot()
    if got is None:
        return None
    snap, _ = got
    cached = snap["counters"].get("probe.cached")
    if cached is None:
        return None
    probes = snap["spans"].get("mm.loop.probe", {}).get("count", 0)
    return 100.0 * cached / (cached + probes)
