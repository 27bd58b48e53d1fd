"""cudaStreamSynchronize calls in the traced window over the frames it
rendered (a batch's jobs count one frame each): the host's waits for the
device inside the program's render."""


def read(r: dict):
    if not r.get("frames"):
        return None
    return r["summary"].syncs / r["frames"]
