"""Smoke test of ``python -m repro_torch.serve``: start the server, POST one
request, assert 200 and the right log|det|, and assert that serving it
built no plan and loaded no kernel: ``/stats`` shows the same
``serve.plan_cache.misses`` and ``kernel_loads`` after the requests as
after warmup, and on the card ``kernel_loads`` is 1 already after warmup.

The twin of ``tools/serve_smoke.py`` (which counts the JAX package's
traces).  Spawns the real entry point as a subprocess (``--port 0``,
``REPRO_OBS=metrics`` so the plan-cache counters are kept, its obs
artifacts in a temporary directory), waits for the ``serving on
http://...`` ready line, then exercises the public HTTP surface.

Usage::

    PYTHONPATH=src python tools/serve_smoke_torch.py [--device cpu]

Without ``--device`` the server runs on the card (and fails without one).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
READY = re.compile(r"serving on http://([\d.]+):(\d+)")
MISSES = "serve.plan_cache.misses"


def _stats(base: str) -> dict:
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
        return json.load(resp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="the server's --device (default: the card)")
    args = ap.parse_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["REPRO_OBS"] = "metrics"
    cmd = [sys.executable, "-m", "repro_torch.serve", "serve", "--port", "0",
           "--buckets", "16,32", "--max-batch", "2"]
    if args.device:
        cmd += ["--device", args.device]
    with tempfile.TemporaryDirectory() as obs_dir:
        env["REPRO_OBS_DIR"] = obs_dir
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            return _drive(proc)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def _drive(proc) -> int:
    deadline = time.monotonic() + 300
    host = port = None
    for line in proc.stdout:
        print("server:", line.rstrip())
        m = READY.search(line)
        if m:
            host, port = m.group(1), int(m.group(2))
            break
        if time.monotonic() > deadline:
            raise TimeoutError("server never printed the ready line")
    if port is None:
        raise RuntimeError(
            f"server exited (rc={proc.wait()}) before becoming ready")

    base = f"http://{host}:{port}"
    warm_stats = _stats(base)
    warm, loads = warm_stats["counters"].get(MISSES), \
        warm_stats["kernel_loads"]
    if not warm:
        raise RuntimeError(f"warmup recorded no plan-cache miss: {warm!r}")
    if loads != (warm_stats["device"] != "cpu"):
        raise RuntimeError(f"kernel libraries loaded {loads} times by "
                           f"warmup on {warm_stats['device']}")
    matrix = [[4.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 5.0]]
    req = urllib.request.Request(
        f"{base}/v1/logdet",
        data=json.dumps({"matrix": matrix}).encode(),
        headers={"Content-Type": "application/json"})
    for _ in range(2):
        with urllib.request.urlopen(req, timeout=120) as resp:
            if resp.status != 200:
                raise RuntimeError(f"status {resp.status}")
            body = json.load(resp)
        print("response:", body)
        if not (math.isfinite(body["logabsdet"])
                and abs(body["logabsdet"] - math.log(51.0)) < 1e-6):
            raise RuntimeError(f"wrong log|det|: {body}")
    stats = _stats(base)
    after = stats["counters"].get(MISSES)
    if after != warm:
        raise RuntimeError(f"request-time plan build: {MISSES} {warm} -> "
                           f"{after}")
    if stats["kernel_loads"] != loads:
        raise RuntimeError(f"request-time kernel load: kernel_loads {loads} "
                           f"-> {stats['kernel_loads']}")
    print(f"serve smoke OK on {stats['device']} (plans built at warmup: "
          f"{warm:g}, at request time: 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
