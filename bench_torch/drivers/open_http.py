"""Open loop of HTTP requests to the program's render service
(`mathmap_tpu_torch.serve`: `serve(port=0, block=False)` over a
`RenderService` on the device, in this process).

Traffic parameters (traffic/<mix>.json):

- `width`, `height`: the request image's size and the render's;
- `rate_per_s`: the offered load. A window of S seconds holds
  round(rate x S) requests, due at gaps that are the exponential
  distribution's quantiles at that rate, in an order drawn from the seed,
  so every seed offers the same arrivals in another order;
- `texture_levels`, `png_level`: the request image is the seed's smooth
  image plus a texture of that many levels, PNG-encoded once in set-up
  (zlib level `png_level`); every request carries it;
- requests take the configuration's filters in turn, each with params
  drawn from the seed, `"binary": true` (the reply is the PNG itself)
  and the service's default uint8 output;
- `sample`: replies kept for the comparison, drawn from the seed;
- `threads`: the client's sending threads; `lead_s`: the time from the
  client's start to the first due request; `grace_s`: how long after the
  window's close replies still count.

End-to-end value: `request_p95_ms`, the 95th percentile over every request
due in the window of the time from its due time to its reply's last byte;
a request that failed or never came counts as the whole wait, window and
grace, after its due time.
"""

from __future__ import annotations

import base64
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from bench_torch.drivers import Window, http_client
from bench_torch.harness import images, manifest, params, stats

CLIENT = Path(http_client.__file__).resolve()


def pack_uint8(rgba: torch.Tensor) -> torch.Tensor:
    """The 8-bit rule: clip to [0, 1], x 255 + 0.5, floor."""
    return torch.floor(torch.clamp(rgba.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def arrivals(n: int, seconds: float, rng: np.random.Generator) -> list:
    """n due times in [0, seconds): the exponential quantiles' gaps in an
    order drawn by `rng`, scaled to the window."""
    if n < 1:
        return []
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    rng.shuffle(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return (due * (seconds / gaps.sum())).tolist()


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device, mt, traffic: dict):
        self.cell, self.seed, self.dev, self.mt = cell, seed, dev, mt
        self.tr = traffic
        self.w, self.h = int(traffic["width"]), int(traffic["height"])
        self.specs = cell.config["filters"]
        self.kept = {}
        self.requests = []
        self.tmp = None
        self.svc = None

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from mathmap_tpu_torch import serve as service_mod

        seed = self.seed % 2**64
        img = images.smooth_image(self.w, self.h, seed, self.dev)
        levels = int(self.tr.get("texture_levels", 0))
        if levels:
            img = images.textured(img, levels, seed)
        self.image = img
        self.png = images.encode_png(img.cpu().numpy(), int(self.tr["png_level"]))
        self.tmp = Path(tempfile.mkdtemp(prefix="bench_torch_"))
        (self.tmp / "image.b64").write_bytes(base64.b64encode(self.png))
        self.svc = service_mod.RenderService(device=self.dev)
        self.httpd, _ = service_mod.serve(port=0, service=self.svc, block=False)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        # warm-up: each filter twice through the whole route
        image_b64 = base64.b64encode(self.png)
        rng = np.random.default_rng([seed, 3])
        for _ in range(2):
            for spec in self.specs:
                status, _ = http_client.post(
                    self.port, http_client.body(self.head(spec, rng), image_b64), 600.0)
                if status != 200:
                    raise RuntimeError(f"warm-up request for {spec['name']} failed: {status}")

    def head(self, spec: dict, rng, job_params=None, t=None) -> str:
        return json.dumps({"filter": {"source": spec["source"]}, "width": self.w,
                           "height": self.h,
                           "t": params.draw_t(rng) if t is None else t,
                           "params": (params.draw(spec.get("params", {}), rng)
                                      if job_params is None else job_params),
                           "binary": True})

    def plan(self, seconds: float, rate: float) -> list:
        """The window's requests: (filter index, params, t, due offset)."""
        seed = self.seed % 2**64
        n = int(round(rate * seconds))
        due = arrivals(n, seconds, np.random.default_rng([seed, 4]))
        rng = np.random.default_rng([seed, 1])
        out = []
        for k in range(n):
            f_idx = k % len(self.specs)
            ps = params.draw(self.specs[f_idx].get("params", {}), rng)
            out.append((f_idx, ps, params.draw_t(rng), due[k]))
        return out

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, profiler=None, rate: float | None = None) -> Window:
        rate = float(self.tr["rate_per_s"]) if rate is None else rate
        self.requests = self.plan(seconds, rate)
        n = len(self.requests)
        pick = np.random.default_rng([self.seed % 2**64, 2])
        keep = sorted(pick.choice(n, size=min(int(self.tr["sample"]), n), replace=False).tolist())
        outdir = self.tmp / "replies"
        shutil.rmtree(outdir, ignore_errors=True)
        outdir.mkdir()
        lead, grace = float(self.tr["lead_s"]), float(self.tr["grace_s"])
        t0 = time.monotonic() + lead
        give_up = t0 + seconds + grace
        spec = {"port": self.port, "t0": t0, "due": [r[3] for r in self.requests],
                "heads": [self.head(self.specs[f], None, ps, t) for f, ps, t, _ in self.requests],
                "png_b64": str(self.tmp / "image.b64"), "keep": keep, "outdir": str(outdir),
                "give_up": give_up, "threads": int(self.tr["threads"])}
        (self.tmp / "spec.json").write_text(json.dumps(spec))
        client = subprocess.Popen([sys.executable, str(CLIENT), str(self.tmp / "spec.json")],
                                  stdout=subprocess.PIPE, text=True)
        try:
            if profiler is not None:
                profiler.start()
            before = self.svc.snapshot()
            start = time.perf_counter() + (t0 - time.monotonic())
            time.sleep(max(t0 - time.monotonic(), 0.0))
            if profiler is not None:
                profiler.open_now()
            out, _ = client.communicate(timeout=lead + seconds + grace + 120)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
        if profiler is not None:
            profiler.stop()
        after = self.svc.snapshot()
        if client.returncode != 0:
            raise RuntimeError(f"the load client exited with {client.returncode}")
        results = json.loads(out)["requests"]
        lat, late, failed = [], [], 0
        for k, (status, late_s, latency, _) in enumerate(results):
            if late_s is not None:
                late.append(late_s * 1e3)
            if status == 200 and latency is not None:
                lat.append(latency * 1e3)
            else:
                failed += 1
                lat.append((give_up - t0 - self.requests[k][3]) * 1e3)
        self.kept = {k: outdir / f"{k}.png" for k in keep}
        values = {"request_p95_ms": stats.percentile(lat, 95)}
        return Window(attempted=n, failed=failed, start=start, seconds=seconds, values=values,
                      timings={"request_ms": lat, "send_late_ms": late},
                      extra={"before": before, "after": after})

    def release(self):
        if self.svc is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.svc.shutdown()
            self.thread.join(timeout=10)
            self.svc = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def close(self):
        self.release()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    # -- the comparison -----------------------------------------------------
    def compare(self, comparison, control: bool = False):
        for k, path in self.kept.items():
            f_idx, ps, t, _ = self.requests[k]
            ref = manifest.reference(self.specs[f_idx]["reference"])
            want = pack_uint8(ref(ps, t, self.w, self.h, self.image, torch.float32, self.dev))
            if control:
                got = pack_uint8(ref(ps, t, self.w, self.h, self.image, torch.bfloat16, self.dev))
            else:
                got = None
                if path.exists():
                    try:
                        got = torch.from_numpy(images.decode_png(path.read_bytes())).to(self.dev)
                    except ValueError as exc:
                        print(f"reply {k}: {exc}", file=sys.stderr)
            comparison.add(got, want)

    # -- per-layer readings -------------------------------------------------
    def readings(self, window: Window, summary) -> dict:
        return {"summary": summary, "service_before": window.extra["before"],
                "service_after": window.extra["after"]}

