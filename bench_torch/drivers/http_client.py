"""The open loop's client, a process of its own so that it shares no
interpreter lock with the service it loads. It imports no torch.

    python3 bench_torch/drivers/http_client.py SPEC.json > results.json

The spec: `port`; `t0` (a time.monotonic() reading shared by every process
of the machine); `due`, each request's send time in seconds after t0;
`heads`, each request's JSON body without its `inputs`; `png_b64`, the
path of the base64 request image every request carries; `keep`, the
requests whose replies are written to `outdir/<index>.png`; `give_up`,
the monotonic time after which a reply no longer counts; `threads`.

Each request is sent from a pool thread at its due time, whatever is
still outstanding; its latency runs from the due time to the reply's last
byte. Prints one JSON object: per request [HTTP status or null, seconds
late at send, latency in seconds or null, reply bytes].
"""

from __future__ import annotations

import concurrent.futures as cf
import http.client
import json
import sys
import time
from pathlib import Path


def body(head: str, image_b64: bytes) -> bytes:
    return head[:-1].encode() + b', "inputs": ["' + image_b64 + b'"]}'


def post(port: int, data: bytes, timeout: float) -> tuple:
    """-> (status, reply bytes) of one POST /render on 127.0.0.1."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/render", data, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run(spec: dict) -> dict:
    image_b64 = Path(spec["png_b64"]).read_bytes()
    t0, give_up, port = spec["t0"], spec["give_up"], spec["port"]
    keep = set(spec["keep"])
    outdir = Path(spec["outdir"])
    results = [[None, None, None, 0] for _ in spec["due"]]

    def send(k: int):
        due = t0 + spec["due"][k]
        sent = time.monotonic()
        results[k][1] = sent - due
        try:
            status, data = post(port, body(spec["heads"][k], image_b64),
                                max(give_up - sent, 0.1))
        except (OSError, http.client.HTTPException):
            return
        done = time.monotonic()
        results[k][0] = status
        results[k][3] = len(data)
        if done <= give_up:
            results[k][2] = done - due
        if k in keep and status == 200:
            (outdir / f"{k}.png").write_bytes(data)

    pool = cf.ThreadPoolExecutor(max_workers=int(spec["threads"]))
    futures = []
    for k, offset in enumerate(spec["due"]):
        wait = t0 + offset - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(send, k))
    cf.wait(futures, timeout=max(give_up - time.monotonic(), 0.0) + 1.0)
    pool.shutdown(wait=True)
    for f in futures:
        f.result()
    return {"requests": results}


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    json.dump(run(spec), sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
