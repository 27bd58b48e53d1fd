"""Bytes the parallel layer copies between devices a frame, in MB (1e6
bytes): the program's counter `shard.peer_bytes` (input replicas and
tiles moved for assembly to a device other than their own) over the
profiled slice's calls, as the driver read it before and after the slice
(`slice_counters`), over the slice's frames. Nothing to read where the
program counts no `shard.tiles` there, as a program from before the
parallel layer's counters does."""


def read(r: dict):
    counters = r.get("slice_counters")
    if not counters or not counters.get("shard.tiles") or not r.get("frames"):
        return None
    return counters.get("shard.peer_bytes", 0) / r["frames"] / 1e6
