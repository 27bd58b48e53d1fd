"""The open loop: arrivals fixed by the rate and ordered by the seed, and
latency timed from the due time, with failed requests kept in."""

import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

from bench_torch.drivers import http_client, open_http


def test_arrivals_are_the_same_set_in_another_order():
    a = open_http.arrivals(60, 10.0, np.random.default_rng(1))
    b = open_http.arrivals(60, 10.0, np.random.default_rng(2))
    assert len(a) == len(b) == 60
    assert a[0] == b[0] == 0.0 and all(0 <= t < 10.0 for t in a + b)
    assert a == sorted(a) and a != b
    assert sorted(np.diff(a + [10.0])) == pytest.approx(sorted(np.diff(b + [10.0])))


class _Slow(BaseHTTPRequestHandler):
    """One request at a time (HTTPServer is not threading): each takes
    0.2 s, and the third is refused."""
    count = 0

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        type(self).count += 1
        time.sleep(0.2)
        code = 500 if type(self).count == 3 else 200
        self.send_response(code)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")


def test_latency_runs_from_the_due_time(tmp_path: Path):
    httpd = HTTPServer(("127.0.0.1", 0), _Slow)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        (tmp_path / "img.b64").write_bytes(b"AAAA")
        t0 = time.monotonic() + 0.5
        spec = {"port": httpd.server_address[1], "t0": t0, "due": [0.0, 0.0, 0.0, 0.0],
                "heads": [json.dumps({"n": k}) for k in range(4)],
                "png_b64": str(tmp_path / "img.b64"), "keep": [0], "outdir": str(tmp_path),
                "give_up": t0 + 30.0, "threads": 8}
        (tmp_path / "spec.json").write_text(json.dumps(spec))
        out = subprocess.run([sys.executable, http_client.__file__, str(tmp_path / "spec.json")],
                             capture_output=True, text=True, timeout=60, check=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
    res = json.loads(out.stdout)["requests"]
    lat = sorted(r[2] for r in res)
    # all four due at once, served one after another: the k-th waits for
    # the k before it, so its latency from the due time is at least
    # 0.2 (k + 1) s (more on a loaded machine, never less)
    for k, v in enumerate(lat):
        assert 0.2 * (k + 1) - 0.02 <= v < 0.2 * (k + 1) + 2.0
    assert sorted(r[0] for r in res) == [200, 200, 200, 500]
    assert (tmp_path / "0.png").read_bytes() == b"ok"
