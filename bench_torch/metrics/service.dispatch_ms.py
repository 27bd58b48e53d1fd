"""The mean time, in ms, from a job's enqueue to its result in the
service's dispatcher over the window's jobs: the difference of two
RenderService.snapshot() readings around the window (latency summed as
mean_latency_ms x jobs)."""


def _sums(s: dict) -> tuple:
    jobs = s.get("jobs", 0)
    mean = s.get("mean_latency_ms")
    return jobs, (mean * jobs if mean is not None else 0.0)


def read(r: dict):
    if "service_after" not in r:
        return None
    j0, l0 = _sums(r["service_before"])
    j1, l1 = _sums(r["service_after"])
    if j1 <= j0:
        return None
    return (l1 - l0) / (j1 - j0)
