"""Device kernels (copies and memsets left out) in the traced window over
the frames it rendered."""


def read(r: dict):
    if not r.get("frames"):
        return None
    return r["summary"].kernels / r["frames"]
